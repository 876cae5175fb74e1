"""The port's interaction data (``pmgt_tpu_torch.data.interactions``), the
PMGT-embedding remap (``data.artifacts.load_node_init_emb``) and the item →
node map of PMGT_NCF against the JAX package's, on the same numpy inputs.

- ``InteractionData.build`` and ``user_row_index``: every field equal.
- Negative sampling: JAX's own draws reproduced exactly — its ``ng_sample``
  draws ranks with ``jax.random.randint(key, ..., 0, comp)``; the same
  ranks, passed to the port's ``ng_sample``, give the same items. The
  port's own draws (a torch generator) are uniform over each row's
  complement: TV distance to uniform < 0.05 (the pattern of
  ``tests/test_sampler_parity.py``) and never a positive.
- ``epoch_training_arrays`` and ``build_eval_candidates`` (both
  tie-break modes): equal arrays under JAX's negatives and shuffle seed.
- ``train_valid_split``: sklearn's split (the JAX one calls sklearn).
- ``load_node_init_emb``: equal, including the seeded rows of items absent
  from the graph and the L2 normalisation (tolerance 1e-7, float32).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmgt_tpu.data import artifacts as jart
from pmgt_tpu.data import interactions as jint
from pmgt_tpu.tasks.pmgt_ncf_task import _item_to_node_map
from pmgt_tpu_torch.data import artifacts as tart
from pmgt_tpu_torch.data import interactions as tint
from pmgt_tpu_torch.tasks.pmgt_ncf_task import item_to_node_map

NUM_USERS, NUM_ITEMS = 23, 41


def _pairs(seed=0, n=160, users=NUM_USERS, items=NUM_ITEMS):
    rs = np.random.default_rng(seed)
    pairs = np.stack([rs.integers(0, users, n), rs.integers(0, items, n)], 1)
    return np.concatenate([pairs, pairs[:7]]).astype(np.int32)  # duplicates


def _both(pairs, users=NUM_USERS, items=NUM_ITEMS):
    return (jint.InteractionData.build(pairs, users, items),
            tint.InteractionData.build(pairs, users, items))


def _jax_ranks(key, rows, num_ng, num_items):
    """The ranks JAX's ``ng_sample`` draws from ``key``."""
    n_pos = (np.asarray(rows) < num_items).sum(1, keepdims=True)
    comp = np.maximum(num_items - n_pos, 1)
    return np.asarray(jax.random.randint(key, (rows.shape[0], num_ng), 0,
                                         jnp.asarray(comp, jnp.int32), dtype=jnp.int32))


@pytest.mark.parametrize("seed", [0, 1])
def test_interaction_data_build_matches(seed):
    j, t = _both(_pairs(seed))
    for name in ("pairs", "unique_users", "user_pos", "user_pos_count"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    assert (t.num_users, t.num_items) == (j.num_users, j.num_items)
    np.testing.assert_array_equal(t.user_row_index(), j.user_row_index())
    je, te = _both(np.zeros((0, 2), np.int32))
    np.testing.assert_array_equal(te.user_pos, je.user_pos)


@pytest.mark.parametrize("bad", [(-1, 0), (NUM_USERS, 0), (0, NUM_ITEMS)])
def test_build_rejects_out_of_range_ids(bad):
    pairs = np.concatenate([_pairs(), np.array([bad], np.int32)])
    with pytest.raises(ValueError):
        tint.InteractionData.build(pairs, NUM_USERS, NUM_ITEMS)


@pytest.mark.parametrize("num_ng", [1, 4, 60])
def test_ng_sample_reproduces_jax_draws_under_the_same_ranks(num_ng):
    j, t = _both(_pairs(2))
    rows = j.user_pos
    key = jax.random.key(num_ng)
    want = np.asarray(jint.ng_sample(jnp.asarray(j.unique_users), jnp.asarray(rows), key,
                                     num_ng, NUM_ITEMS))
    ranks = _jax_ranks(key, rows, num_ng, NUM_ITEMS)
    got = tint.ng_sample(t.user_pos, num_ng, NUM_ITEMS, rank=ranks).numpy()
    np.testing.assert_array_equal(got, want)
    # the shared walk itself, on ranks of every value
    full = np.tile(np.arange(NUM_ITEMS)[None], (len(rows), 1))
    np.testing.assert_array_equal(
        tint.ng_sample(rows, NUM_ITEMS, NUM_ITEMS, rank=full).numpy(),
        np.asarray(jint._complement_rank_select(jnp.asarray(rows), jnp.asarray(full),
                                                NUM_ITEMS)))


def test_ng_sample_own_draws_are_uniform_over_the_complement():
    pos = np.array([[0, 3, 4, 5, 17, 30, 40, NUM_ITEMS, NUM_ITEMS]], np.int32)
    n = 200_000
    gen = torch.Generator().manual_seed(0)
    draws = tint.ng_sample(np.repeat(pos, 4, 0), n // 4, NUM_ITEMS, gen).numpy().ravel()
    positives = set(pos[pos < NUM_ITEMS].tolist())
    assert not positives & set(draws.tolist())
    comp = np.array([i for i in range(NUM_ITEMS) if i not in positives])
    counts = np.bincount(draws, minlength=NUM_ITEMS)[comp].astype(np.float64)
    uniform = np.full(len(comp), len(draws) / len(comp))
    tv = 0.5 * np.abs(counts - uniform).sum() / len(draws)
    assert tv < 0.05, f"TV distance {tv:.4f}"
    assert counts.min() > 0


@pytest.mark.parametrize("num_ng", [0, 1, 3])
def test_epoch_training_arrays_layout_matches(num_ng):
    j, t = _both(_pairs(3))
    key = jax.random.key(7)
    want = jint.epoch_training_arrays(j, num_ng, key)
    negs = None
    if num_ng:
        rows = j.user_pos[j.user_row_index()[j.pairs[:, 0]]]
        negs = np.asarray(jint.ng_sample(jnp.asarray(j.pairs[:, 0]), jnp.asarray(rows), key,
                                         num_ng, NUM_ITEMS))
    got = tint.epoch_training_arrays(t, num_ng, negs=negs)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("reference_tiebreak", [False, True])
@pytest.mark.parametrize("num_ng", [5, 30])
def test_build_eval_candidates_matches(reference_tiebreak, num_ng):
    j, t = _both(_pairs(4, n=300))
    key = jax.random.key(11)
    want = jint.build_eval_candidates(j, num_ng, key, reference_tiebreak=reference_tiebreak)
    big_l = want[1].shape[1]
    negs = np.asarray(jint.ng_sample(jnp.asarray(j.unique_users), jnp.asarray(j.user_pos), key,
                                     big_l, NUM_ITEMS))
    seed = int(jax.random.randint(jax.random.fold_in(key, 1), (), 0, np.iinfo(np.int32).max))
    got = tint.build_eval_candidates(t, num_ng, reference_tiebreak=reference_tiebreak,
                                     negs=negs, shuffle_seed=seed)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)
    users, cands, mask, labels = got
    # positives first (before the shuffle), each row's positives all present
    for r in range(len(users)):
        pos = set(t.user_pos[r, : t.user_pos_count[r]].tolist())
        assert set(cands[r][labels[r] > 0].tolist()) == pos
        assert mask[r].sum() == max(num_ng, len(pos))


def test_build_eval_candidates_own_draws():
    _, t = _both(_pairs(5, n=300))
    gen = torch.Generator().manual_seed(3)
    users, cands, mask, labels = tint.build_eval_candidates(t, 20, gen)
    again = tint.build_eval_candidates(t, 20, torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(cands, again[1])
    for r in range(len(users)):
        pos = set(t.user_pos[r, : t.user_pos_count[r]].tolist())
        negs = cands[r][(labels[r] == 0) & (mask[r] > 0)]
        assert not pos & set(negs.tolist())


@pytest.mark.parametrize("valid_size", [0.0, 0.2, 0.35])
@pytest.mark.parametrize("seed", [0, 5])
def test_train_valid_split_matches_sklearn(valid_size, seed):
    pairs = _pairs(seed)
    for a, b in zip(tint.train_valid_split(pairs, valid_size, seed),
                    jint.train_valid_split(pairs, valid_size, seed), strict=True):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("normalize", [False, True])
def test_load_node_init_emb_matches(normalize):
    rs = np.random.default_rng(0)
    node_classes = np.array([f"n{i}" for i in range(12)])
    item_classes = np.array(["n3", "x1", "n0", "n11", "x2", "n7"])
    emb = rs.normal(size=(12, 8)).astype(np.float32)
    for ic, nc in ((item_classes, node_classes), (None, None)):
        want = jart.load_node_init_emb(ic, nc, emb, normalize=normalize, seed=4)
        got = tart.load_node_init_emb(ic, nc, emb, normalize=normalize, seed=4)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
        assert got.dtype == np.float32


def test_item_to_node_map_matches():
    class Art:
        num_items = 5
        item_classes = np.array(["a", "b", "z", "d", "e"])
        node_classes = np.array(["e", "d", "a", "b"])

    np.testing.assert_array_equal(item_to_node_map(Art), _item_to_node_map(Art))
    Art.item_classes = Art.node_classes = None
    np.testing.assert_array_equal(item_to_node_map(Art), _item_to_node_map(Art))
    np.testing.assert_array_equal(item_to_node_map(Art), np.arange(2, 7))
