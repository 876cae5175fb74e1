"""The work counts of ``yardstick/flops.py`` against
``torch.utils.flop_counter.FlopCounterMode`` on the plain reference at
a small width."""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import common
from benchmark.reference import plain
from benchmark.yardstick import flops

CFG = {"hidden_size": 32, "intermediate_size": 48, "num_hidden_layers": 2, "num_attention_heads": 1,
       "feat_dims": [40, 24], "beta": 0.5, "hidden_dropout_prob": 0.1,
       "attention_probs_dropout_prob": 0.1, "layer_norm_eps": 1e-12, "max_position_embeddings": 100,
       "initializer_range": 0.02, "max_ctx_neigh": 5, "factor_num": 8, "num_layers": 2}


def _count(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def _setup(lanes=7, s=6, rows=30):
    w = common.make_weights(common.pmgt_ncf_shapes(CFG, 11, rows), CFG, 3, "cpu")
    feats = [torch.randn(rows, f) for f in CFG["feat_dims"]]
    ids = torch.randint(0, rows, (lanes, s))
    return w, feats, ids, torch.ones(lanes, s)


def test_encoder_forward_and_backward():
    w, feats, ids, mask = _setup()
    enc = plain.Encoder(w, CFG, plain.Arith())
    proj = [p.detach().requires_grad_() for p in enc.project_rows(feats, ids)]
    lanes, s = ids.shape
    per_tok = flops.encoder_flops_per_token(32, 48, 2, s, CFG["feat_dims"])
    assert _count(lambda: enc(proj, mask)) == lanes * s * per_tok
    for t in w.values():
        t.requires_grad_(True)
    total = _count(lambda: enc(proj, mask, plain.Draws(0, "cpu"))[:, 0].sum().backward())
    assert total == 3 * lanes * s * per_tok


def test_projection_counts_rows():
    w, feats, ids, _ = _setup()
    enc = plain.Encoder(w, CFG, plain.Arith())
    rows = torch.unique(ids)
    assert _count(lambda: enc.project_rows(feats, rows)) == \
        len(rows) * flops.projection_flops_per_row(32, CFG["feat_dims"])


def test_towers_per_pair():
    w, _, _, _ = _setup()
    pairs = 9
    cls = torch.randn(pairs, 32)
    users, items = torch.randint(0, 11, (pairs,)), torch.randint(0, 30, (pairs,))
    got = _count(lambda: plain.ncf_logits(w, CFG, plain.Arith(), cls, users, items))
    # the GMF product is elementwise: the counter leaves it out
    assert got == pairs * (flops.tower_flops_per_pair(8, 2, 32) - 8)


def test_request_counts_each_item_once():
    one = flops.serve_request_flops(CFG, 1, 100, 100)
    many = flops.serve_request_flops(CFG, 64, 100, 100)
    tower = flops.tower_flops_per_pair(8, 2, 32)
    assert many - one == 63 * 100 * tower
