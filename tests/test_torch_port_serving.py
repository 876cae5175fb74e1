"""The port's downstream tasks (``pmgt_tpu_torch.tasks.{ncf,dcn,pmgt_ncf}_task``
and ``interaction_base``) against the JAX package's, on the CPU.

Serving (``export_topk``), for NCF, DCN and PMGT_NCF with the JAX task's
parameters loaded into the port's (and, for PMGT_NCF, the JAX task's
evaluation contexts):
- the same ids as the JAX task's export and scores within 1e-5;
- brute force: every (user, item) scored, training positives masked,
  a stable sort — the same ids, scores within 1e-6 · max(1, |score|);
- chunked == unchunked (item chunk k against the whole catalogue): the
  same ids, scores within 1e-6 · max(1, |score|) (DCN's scores are O(10));
- with seen items included and k = num_items, every row is a permutation
  of the catalogue;
- a user with fewer than k unseen items gets -1 ids on -inf slots.
The tasks: NCF and PMGT_NCF ranking evaluation on the JAX task's
candidates (loss within 1e-6, NDCG/recall within 1e-12), DCN evaluation on
its examples (AUC and loss within 1e-6), one AdamW training step of NCF
equal to the JAX step (parameters within 1e-6), the frozen item table
(zeroed gradients and no decay: unchanged after a step), gradient
accumulation (the mean of the micro-batch gradients, within 1e-6), and
epoch arrays keyed on the epoch.
"""
from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmgt_tpu.core.config import TrainArgs as JArgs
from pmgt_tpu.data import interactions as jint
from pmgt_tpu.data.synthetic import make_synthetic_dataset as jmake
from pmgt_tpu.tasks import dcn_task as jdcn_task
from pmgt_tpu.tasks import ncf_task as jncf_task
from pmgt_tpu.tasks import pmgt_ncf_task as jpmgt_ncf_task
from pmgt_tpu_torch.core.config import TrainArgs as TArgs
from pmgt_tpu_torch.core.mesh import chunk_eval_inputs
from pmgt_tpu_torch.data import interactions as tint
from pmgt_tpu_torch.data.synthetic import make_synthetic_dataset as tmake
from pmgt_tpu_torch.models.interop import (
    dcn_params_from_flax,
    ncf_params_from_flax,
    pmgt_ncf_params_from_flax,
)
from pmgt_tpu_torch.tasks import dcn_task, ncf_task, pmgt_ncf_task

NUM_USERS, NUM_ITEMS = 13, 17
EXTRA = {
    "ncf": dict(factor_num=4, num_layers=2, num_ng=1, max_sample_items=10),
    "dcn": dict(factor_num=4, deep_net_num_layers=2, cross_net_num_layers=2, num_ng=1),
    "pmgt_ncf": dict(factor_num=4, num_layers=2, num_ng=1, max_sample_items=10, hidden_size=16,
                     intermediate_size=16, num_hidden_layers=2, hop_sampling_sizes=(4, 2)),
}
MODEL = {"ncf": "NeuMF-end", "dcn": "DCN", "pmgt_ncf": "NeuMF-end"}


def _pairs():
    rng = np.random.default_rng(0)
    pairs = []
    for u in range(NUM_USERS):
        if u == 5:  # a cold user
            continue
        items = rng.choice(NUM_ITEMS, size=rng.integers(1, 6), replace=False)
        pairs.extend((u, i) for i in items)
    return np.asarray(pairs, np.int32)


def _splits(mod, pairs=None):
    """(train, valid, test) InteractionData of ``mod`` (the JAX or the port
    module): all pairs, every other pair, the rest."""
    pairs = _pairs() if pairs is None else pairs
    parts = (pairs, pairs[::2], pairs[1::2])
    return tuple(mod.InteractionData.build(p, NUM_USERS, NUM_ITEMS) for p in parts)


@pytest.fixture(scope="module")
def art():
    kw = dict(num_nodes=NUM_ITEMS, num_users=NUM_USERS, feat_dims=(12, 8), avg_degree=4,
              interactions_per_user=4, seed=3)
    return jmake(**kw), tmake(**kw)


def _tasks(kind, art, pairs=None, **extra):
    """(JAX task, port task on the CPU with the JAX task's parameters)."""
    e = {**EXTRA[kind], **extra}
    jargs = JArgs(model_name=MODEL[kind], dataset_name="syn", seed=0, train_batch_size=8,
                  test_batch_size=128, num_devices=1, extra=dict(e))
    targs = TArgs(model_name=MODEL[kind], dataset_name="syn", seed=0, train_batch_size=8,
                  test_batch_size=128, extra=dict(e))
    jmod = {"ncf": jncf_task, "dcn": jdcn_task, "pmgt_ncf": jpmgt_ncf_task}[kind]
    tmod = {"ncf": ncf_task, "dcn": dcn_task, "pmgt_ncf": pmgt_ncf_task}[kind]
    name = {"ncf": "NCFTask", "dcn": "DCNTask", "pmgt_ncf": "PMGTNCFTask"}[kind]
    jcls, tcls = getattr(jmod, name), getattr(tmod, name)
    jart, tart = (art if kind == "pmgt_ncf" else (None, None))
    jt = jcls(jargs, jart, *_splits(jint, pairs))
    tt = tcls(targs, tart, *_splits(tint, pairs), device="cpu")
    convert = {"ncf": ncf_params_from_flax, "dcn": dcn_params_from_flax,
               "pmgt_ncf": pmgt_ncf_params_from_flax}[kind]
    tt.model.load_state_dict(convert(jax.device_get(jt.state.params)))
    if kind == "pmgt_ncf":
        ids, mask = (np.array(x) for x in jt._get_eval_ctx())
        tt._eval_ctx = (torch.as_tensor(ids).long(), torch.as_tensor(mask))
    return jt, tt


def _jax_export(kind, jt, **kw):
    extras = (jt.feat_tables, jt._get_eval_ctx()) if kind == "pmgt_ncf" else None
    return jt.export_topk(jt.state.params, extras=extras, **kw)


KINDS = ["ncf", "dcn", "pmgt_ncf"]


@pytest.mark.parametrize("kind", KINDS)
def test_export_topk_matches_the_jax_task(kind, art):
    jt, tt = _tasks(kind, art)
    for kw in (dict(k=5, user_batch=4, item_chunk=7), dict(k=3, user_batch=64, item_chunk=64)):
        want = _jax_export(kind, jt, **kw)
        got = tt.export_topk(**kw)
        np.testing.assert_array_equal(got["user_ids"], want["user_ids"])
        np.testing.assert_array_equal(got["item_ids"], want["item_ids"])
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=1e-5)


def _all_scores(tt):
    u = torch.arange(NUM_USERS).repeat_interleave(NUM_ITEMS)
    i = torch.arange(NUM_ITEMS).repeat(NUM_USERS)
    with torch.no_grad():
        return tt.scorer()(u, i).reshape(NUM_USERS, NUM_ITEMS).double().numpy()


@pytest.mark.parametrize("kind", KINDS)
def test_export_topk_matches_brute_force(kind, art):
    _, tt = _tasks(kind, art)
    k = 4
    out = tt.export_topk(k=k, item_chunk=7)
    logits = _all_scores(tt)
    train = tt.train_data
    for r, u in enumerate(train.unique_users):
        logits[u, train.user_pos[r, : train.user_pos_count[r]]] = -np.inf
    want = np.argsort(-logits, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(out["item_ids"], want)
    np.testing.assert_allclose(out["scores"], np.take_along_axis(logits, want, 1),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_export_topk_chunked_equals_unchunked(kind, art):
    _, tt = _tasks(kind, art)
    a = tt.export_topk(k=6, item_chunk=NUM_ITEMS)
    b = tt.export_topk(k=6, item_chunk=6, user_batch=3)
    np.testing.assert_array_equal(a["item_ids"], b["item_ids"])
    np.testing.assert_allclose(a["scores"], b["scores"], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_export_topk_include_seen(kind, art):
    _, tt = _tasks(kind, art)
    out = tt.export_topk(k=NUM_ITEMS, exclude_train=False, item_chunk=5)
    for row in out["item_ids"]:
        assert sorted(row.tolist()) == list(range(NUM_ITEMS))
    assert np.isfinite(out["scores"]).all()


@pytest.mark.parametrize("kind", KINDS)
def test_export_topk_short_tail_is_minus_one(kind, art):
    """User 0 has seen 15 of 17 items: k=5 serves its 2 unseen items, then
    -1 on -inf slots, never an excluded positive."""
    pairs = np.asarray([(0, i) for i in range(15)] + [(1, 0), (NUM_USERS - 1, 3)], np.int32)
    jt, tt = _tasks(kind, art, pairs=pairs)
    out = tt.export_topk(k=5, item_chunk=8)
    row, sc = out["item_ids"][0], out["scores"][0]
    assert set(row[:2].tolist()) == {15, 16} and np.isfinite(sc[:2]).all()
    assert (row[2:] == -1).all() and np.isneginf(sc[2:]).all()
    want = _jax_export(kind, jt, k=5, item_chunk=8)
    np.testing.assert_array_equal(out["item_ids"], want["item_ids"])


def _inject_jax_candidates(jt, tt, split):
    """The JAX task's candidate draw for ``split`` in the port task's
    evaluation cache."""
    data = jt.valid_data if split == "valid" else jt.test_data
    key = jax.random.key(np.uint32(jt.args.seed * 17 + (split == "test")))
    users, cands, mask, labels = jint.build_eval_candidates(
        data, jt.args.extra["max_sample_items"], key)
    arrays = chunk_eval_inputs(tt.eval_chunk_users, (users, cands, mask, labels))
    tt._eval_cache[split] = (len(users), [
        torch.as_tensor(a, dtype=dt) for a, dt in
        zip(arrays, (torch.int64, torch.int64, torch.float32, torch.float32))])


@pytest.mark.parametrize("kind", ["ncf", "pmgt_ncf"])
@pytest.mark.parametrize("split", ["valid", "test"])
def test_ranking_evaluation_matches_the_jax_task(kind, split, art):
    jt, tt = _tasks(kind, art)
    _inject_jax_candidates(jt, tt, split)
    want = jt.evaluate(jt.state, split)
    got = tt.evaluate(split)
    assert set(got) == set(want)
    for k in want:
        tol = 1e-6 if k.endswith("loss") else 1e-12
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])


def test_dcn_evaluation_matches_the_jax_task(art):
    jt, tt = _tasks("dcn", art)
    for split in ("valid", "test"):
        tt.eval_arrays[split] = jt._eval_arrays[split]
        want, got = jt.evaluate(jt.state, split), tt.evaluate(split)
        assert set(got) == set(want)
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])


@pytest.mark.parametrize("freeze", [False, True])
def test_ncf_training_step_matches_the_jax_step(freeze, tmp_path):
    emb = np.random.default_rng(1).normal(size=(NUM_ITEMS, 8)).astype(np.float32)
    extra = {}
    if freeze:
        np.save(tmp_path / "emb.npy", emb)
        extra = dict(item_init_emb_path=str(tmp_path / "emb.npy"), freeze_item_init_emb=True)
    art = types.SimpleNamespace(item_classes=None, node_classes=None)
    jt, tt = _ncf_pair(extra, art)
    rs = np.random.default_rng(2)
    u, i = rs.integers(0, NUM_USERS, 8), rs.integers(0, NUM_ITEMS, 8)
    lab = (rs.random(8) < 0.5).astype(np.float32)
    state, _ = jt._train_step_fn(jt.state, jnp.asarray(u, jnp.int32), jnp.asarray(i, jnp.int32),
                                 jnp.asarray(lab), jax.random.key(0))
    before = {n: p.detach().clone() for n, p in tt.model.named_parameters()}
    tt.train_step((torch.as_tensor(u), torch.as_tensor(i), torch.as_tensor(lab),
                   torch.Generator().manual_seed(0)))
    want = ncf_params_from_flax(jax.device_get(state.params))
    for n, p in tt.model.named_parameters():
        torch.testing.assert_close(p.detach(), want[n], rtol=0, atol=1e-6)
    moved = not torch.equal(tt.model.embed_item_MLP.weight, before["embed_item_MLP.weight"])
    assert moved != freeze
    assert not torch.equal(tt.model.embed_user_MLP.weight, before["embed_user_MLP.weight"])


def _ncf_pair(extra, art):
    e = {**EXTRA["ncf"], **extra}
    kw = dict(model_name="NeuMF-end", dataset_name="syn", seed=0, train_batch_size=8,
              test_batch_size=128, decay=0.1)
    jt = jncf_task.NCFTask(JArgs(num_devices=1, extra=dict(e), **kw), art, *_splits(jint))
    tt = ncf_task.NCFTask(TArgs(extra=dict(e), **kw), art, *_splits(tint), device="cpu")
    tt.model.load_state_dict(ncf_params_from_flax(jax.device_get(jt.state.params)))
    return jt, tt


def test_accumulation_gives_the_mean_of_micro_batch_gradients():
    kw = dict(model_name="NeuMF-end", seed=0, train_batch_size=8, extra=dict(EXTRA["ncf"]))
    two = ncf_task.NCFTask(TArgs(accumulation_step=2, **kw), None, *_splits(tint), device="cpu")
    one = ncf_task.NCFTask(TArgs(**kw), None, *_splits(tint), device="cpu")
    one.model.load_state_dict(two.model.state_dict())
    rs = np.random.default_rng(3)
    u = torch.as_tensor(rs.integers(0, NUM_USERS, 8))
    i = torch.as_tensor(rs.integers(0, NUM_ITEMS, 8))
    lab = torch.as_tensor((rs.random(8) < 0.5).astype(np.float32))
    loss = two.accumulate_gradients((u, i, lab, None))
    got = {n: p.grad.clone() for n, p in two.model.named_parameters()}
    parts, losses = [], []
    for sl in (slice(0, 4), slice(4, 8)):
        losses.append(one.accumulate_gradients((u[sl], i[sl], lab[sl], None)))
        parts.append({n: p.grad.clone() for n, p in one.model.named_parameters()})
    assert abs(loss.item() - (losses[0] + losses[1]).item() / 2) <= 1e-6
    for n, g in got.items():
        torch.testing.assert_close(g, (parts[0][n] + parts[1][n]) / 2, rtol=0, atol=1e-6)


def test_epoch_arrays_are_keyed_on_the_epoch():
    kw = dict(model_name="NeuMF-end", seed=4, train_batch_size=4, extra=dict(EXTRA["ncf"]))
    a = ncf_task.NCFTask(TArgs(**kw), None, *_splits(tint), device="cpu")
    b = ncf_task.NCFTask(TArgs(**kw), None, *_splits(tint), device="cpu")
    a.on_epoch_start(1)
    first = [x[:3] for x in a.train_batches(0)]  # epoch 0 after epoch 1
    fresh = [x[:3] for x in b.train_batches(0)]
    assert len(first) == len(fresh) > 0
    for x, y in zip(first, fresh):
        for s, t in zip(x, y):
            assert torch.equal(s, t)
    other = [x[1] for x in b.train_batches(1)]
    assert any(not torch.equal(s, t[1]) for s, t in zip(other, fresh))
