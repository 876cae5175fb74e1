"""Serving encodes each catalogue item once a ``serve_users`` call
(``pmgt_tpu_torch.tasks.interaction_base``, ``PMGTNCFTask.scorer``,
``PMGT_NCF.encode_items`` / ``towers``), on the CPU:

- PMGT_NCF's ``serve_users`` gives the ids of scoring every (user, item)
  pair through ``scorer()(users, items)``, scores within 1e-6 ·
  max(1, |score|), whether a tile's pairs hold the catalogue or not;
- the encoder sees each catalogue item exactly once a call, whatever the
  number of users or the tile;
- ``PMGT_NCF.forward`` with dropout is ``towers`` over ``encode_items``
  bit for bit and leaves the generator in the same state;
- NCF's and DCN's scorers have no item stage, and their ``serve_users``
  runs no more operations than the tile loop that scored each tile
  through ``score(users, items)``;
- ``export_topk`` makes as many encoder calls as ``chip_smoke.py``
  expects K1 launches a layer (``serve_encoder_calls``).
"""
from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pmgt_tpu_torch.core.config import PMGTConfig, TrainArgs
from pmgt_tpu_torch.data import interactions
from pmgt_tpu_torch.data.synthetic import make_synthetic_dataset
from pmgt_tpu_torch.models.pmgt import PMGTModel
from pmgt_tpu_torch.models.pmgt_ncf import PMGT_NCF
from pmgt_tpu_torch.sampling.mcn import topk_lowest_index
from pmgt_tpu_torch.tasks.dcn_task import DCNTask
from pmgt_tpu_torch.tasks.ncf_task import NCFTask
from pmgt_tpu_torch.tasks.pmgt_ncf_task import PMGTNCFTask

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

NUM_NODES, NUM_USERS = 37, 11
ENCODER = dict(hidden_size=16, intermediate_size=16, num_hidden_layers=2,
               hop_sampling_sizes=(4, 2))


@pytest.fixture(scope="module")
def artifacts():
    return make_synthetic_dataset(num_nodes=NUM_NODES, num_users=NUM_USERS, feat_dims=(12, 8),
                                  avg_degree=4, interactions_per_user=4, seed=7)


def _splits(art):
    pairs = art.train_pairs
    return [interactions.InteractionData.build(p, art.num_users, art.num_items)
            for p in (pairs, pairs[::2], pairs[1::2])]


def _task(kind, art):
    if kind == "pmgt_ncf":
        args = TrainArgs(seed=3, train_batch_size=8, model_name="NeuMF-end",
                         extra=dict(ENCODER, factor_num=4, num_layers=2, num_ng=1))
        return PMGTNCFTask(args, art, *_splits(art), device="cpu")
    if kind == "ncf":
        args = TrainArgs(seed=3, train_batch_size=8, model_name="NeuMF-end",
                         extra=dict(factor_num=4, num_layers=2, num_ng=1))
        return NCFTask(args, None, *_splits(art), device="cpu")
    args = TrainArgs(seed=3, train_batch_size=8, model_name="DCN",
                     extra=dict(factor_num=4, deep_net_num_layers=2, cross_net_num_layers=2,
                                num_ng=1))
    return DCNTask(args, None, *_splits(art), device="cpu")


def _serve(task, users, chunk, k=5, score=None):
    pos = torch.as_tensor(task.positives(), dtype=torch.int64)
    u = torch.as_tensor(users, dtype=torch.int64)
    return task.serve_users(score or task.scorer(), u, pos[u], k, chunk)


@pytest.mark.parametrize("users,chunk", [
    ((0, 4), 5),  # 10 pairs a tile, under the catalogue: the item stage in 4 calls
    (tuple(range(NUM_USERS)), 8),  # 88 pairs a tile, over it: one call
])
def test_pmgt_ncf_serving_equals_every_pair_scored(artifacts, users, chunk):
    task = _task("pmgt_ncf", artifacts)
    k = 6
    ids, scores = _serve(task, users, chunk, k)
    u = torch.as_tensor(users).repeat_interleave(NUM_NODES)
    i = torch.arange(NUM_NODES).repeat(len(users))
    with torch.no_grad():
        logits = task.scorer()(u, i).reshape(len(users), NUM_NODES).double().numpy()
    train = task.train_data
    rows = {int(x): r for r, x in enumerate(train.unique_users)}
    for j, user in enumerate(users):
        if user in rows:
            r = rows[user]
            logits[j, train.user_pos[r, : train.user_pos_count[r]]] = -np.inf
    want = np.argsort(-logits, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(ids.numpy(), want)
    np.testing.assert_allclose(scores.double().numpy(), np.take_along_axis(logits, want, 1),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("users,chunk", [(1, NUM_NODES), (1, 6), (4, 5), (NUM_USERS, 16)])
def test_the_encoder_sees_each_item_once_a_call(artifacts, monkeypatch, users, chunk):
    task = _task("pmgt_ncf", artifacts)
    score = task.scorer()  # its table projections are no encoder lanes
    lanes, items = [], []
    encoder, sequences = PMGTModel.forward, task._sequences

    def counted(self, feat_embeds, *args, **kwargs):
        lanes.append(int(feat_embeds[0].shape[0]))
        return encoder(self, feat_embeds, *args, **kwargs)

    def seen(ids, ctx):
        items.append(ids.clone())
        return sequences(ids, ctx)

    monkeypatch.setattr(PMGTModel, "forward", counted)
    monkeypatch.setattr(task, "_sequences", seen)
    _serve(task, range(users), chunk, score=score)
    assert sum(lanes) == NUM_NODES and max(lanes) <= users * chunk
    assert torch.equal(torch.sort(torch.cat(items))[0], torch.arange(NUM_NODES))


@pytest.mark.parametrize("user_batch,item_chunk,k", [(64, 1024, 100), (4, 5, 5), (3, 2, 4)])
def test_export_makes_the_encoder_calls_the_smoke_expects(artifacts, monkeypatch, user_batch,
                                                          item_chunk, k):
    task = _task("pmgt_ncf", artifacts)
    calls = []
    encoder = PMGTModel.forward

    def counted(self, *args, **kwargs):
        calls.append(1)
        return encoder(self, *args, **kwargs)

    monkeypatch.setattr(PMGTModel, "forward", counted)
    task.export_topk(k=k, user_batch=user_batch, item_chunk=item_chunk)
    assert len(calls) == chip_smoke.serve_encoder_calls(NUM_USERS, NUM_NODES, user_batch,
                                                        item_chunk, k)


@pytest.mark.parametrize("model,strategy,dtype", [
    ("NeuMF-end", "project_tables", "float32"),
    ("MLP", "gather_rows", "float32"),
    ("NeuMF-end", "gather_rows", "bfloat16"),
])
def test_forward_is_towers_over_encode_items(model, strategy, dtype):
    item_num, b, s = 10, 6, 5
    cfg = PMGTConfig(hidden_size=16, feat_hidden_sizes=(12, 8), intermediate_size=16,
                     num_hidden_layers=2, dtype=dtype)
    cfg = dataclasses.replace(cfg, fusion_strategy=strategy)
    net = PMGT_NCF(7, item_num, cfg, factor_num=4, num_layers=2, emb_dropout=0.2,
                   dropout=0.3, model=model)
    net.init_weights(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    tables = [torch.as_tensor(rng.normal(size=(item_num + 2, d)), dtype=torch.float32)
              for d in cfg.feat_hidden_sizes]
    user = torch.as_tensor(rng.integers(0, 7, b))
    seqs = torch.as_tensor(rng.integers(0, item_num + 2, (b, s)))
    mask = torch.as_tensor(rng.integers(0, 2, (b, s)), dtype=torch.float32)
    mask[:, 0] = 1.0
    item = torch.as_tensor(rng.integers(0, item_num, b))
    g1, g2 = (torch.Generator().manual_seed(11) for _ in range(2))
    want = net(tables, user, seqs, mask, item=item, deterministic=False, generator=g1)
    cls = net.encode_items(tables, seqs, mask, deterministic=False, generator=g2)
    got = net.towers(user, cls, item, deterministic=False, generator=g2)
    assert cls.dtype == net.bert.dtype and got.dtype == torch.float32
    assert torch.equal(got, want)
    assert torch.equal(g1.get_state(), g2.get_state())


def _tile_loop_scoring_each_tile(task, score, users, pos, k, chunk):
    """The serving loop as it ran before the item stage: each tile's
    (user, item) pairs through ``score(users, items)``, then the merge."""
    data, b = task.train_data, users.shape[0]
    carry = (torch.zeros(b, k, dtype=torch.int64), torch.full((b, k), float("-inf")))
    for start in range(0, int(data.num_items), chunk):
        items = start + torch.arange(chunk)
        u = torch.clamp(users, max=max(data.num_users - 1, 0))[:, None].expand(b, chunk)
        it = torch.clamp(items, max=data.num_items - 1)[None, :].expand(b, chunk)
        logits = score(u.reshape(-1), it.reshape(-1)).reshape(b, chunk).float()
        neg_inf = torch.tensor(float("-inf"))
        idx = pos - start
        idx = torch.where((idx >= 0) & (idx < chunk), idx, chunk)
        padded = torch.cat([logits, torch.zeros(b, 1)], dim=1)
        logits = padded.scatter(1, idx, neg_inf.expand(idx.shape))[:, :chunk]
        logits = torch.where(items[None, :] < data.num_items, logits, neg_inf)
        all_ids = torch.cat([carry[0], items[None, :].expand(b, chunk)], dim=1)
        all_sc = torch.cat([carry[1], logits], dim=1)
        best, idx = topk_lowest_index(all_sc, k)
        carry = torch.gather(all_ids, 1, idx), best
    return carry


def _aten_ops(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, sum(e.name.startswith("aten::") for e in prof.events())


@pytest.mark.parametrize("kind", ["ncf", "dcn"])
def test_models_without_an_item_stage_run_no_more_operations(artifacts, monkeypatch, kind):
    task = _task(kind, artifacts)
    score = task.scorer()
    assert score.items is None
    users = torch.arange(4)
    pos = torch.as_tensor(task.positives(), dtype=torch.int64)[users]
    calls = []
    forward = type(task.model).forward

    def counted(self, user, *args, **kwargs):
        calls.append(int(user.shape[0]))
        return forward(self, user, *args, **kwargs)

    monkeypatch.setattr(type(task.model), "forward", counted)
    with torch.no_grad():
        (ids, sc), ops = _aten_ops(lambda: task.serve_users(score, users, pos, 5, 8))
        assert calls == [4 * 8] * -(-NUM_NODES // 8)  # once a tile, nothing before
        (want_ids, want_sc), before = _aten_ops(
            lambda: _tile_loop_scoring_each_tile(task, score, users, pos, 5, 8))
    assert torch.equal(ids, want_ids) and torch.equal(sc, want_sc)
    assert ops <= before, (ops, before)
