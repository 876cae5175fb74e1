"""Whole training epochs of the port's interaction tasks against the JAX
package's, on the CPU: DCN with the sensitivity tool's hyper-parameters
(``tools/dcn_sensitivity.py:119-136``: factor 32, deep 2, cross 3, layer
norm, the injected table normalised, lr 1e-3, decay 1e-3, clip 5.0,
``num_ng`` 1) and NCF NeuMF-end, each with the injected item table frozen
and trainable.

Both tasks start from the JAX task's initial parameters and train one
epoch of 31 steps on the JAX task's own epoch arrays, each through its own
``train_epoch`` (the JAX one is the ``lax.scan`` path), with dropout 0 so
the two can agree exactly. So every step's AdamW moments, bias correction,
schedule, the clip by global norm after the frozen table's gradient is
zeroed, and the frozen table's exclusion from decay are held over many
steps, where the one-step tests of ``test_torch_port_serving.py`` hold
the first. Checks: every step's loss and every parameter after the epoch
within atol 1e-5 of the JAX package's, a frozen table bit-equal to the
injected one, and ``evaluate`` on the JAX task's evaluation arrays within
1e-6.

The epoch runs in f64 on both sides (``jax.enable_x64`` scoped to the
test, the port's model in ``double``), as
``test_dcn_forward_and_gradients_match`` does. In f32 the DCN parts at the
first update: every cross layer's output is ``x0 * (1 + x1 @ w)`` under a
LayerNorm, which is blind to the row's scale, so each cross weight and
every LayerNorm of the cross net but the last has a true gradient of 0,
except through rows where ``1 + x1 @ w`` comes near 0 and LayerNorm's
eps (1e-12) is felt. Elsewhere what each package computes for them is
its own rounding noise, 1e-16 to 4e-8 in f32 (about AdamW's eps, 1e-8),
and Adam divides it by its own magnitude: the two packages move those
parameters by up to lr a step in directions of their own. In f32 the
second step's loss already parts by 4e-3 and the parameters by 2e-2
after the epoch (NCF stays within 5e-6). In f64 that noise is far below
eps. The evaluation then runs in f32 from each package's trained
parameters, as the tasks evaluate.
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
from pmgt_tpu.tasks import dcn_task as jdcn_task
from pmgt_tpu.tasks import ncf_task as jncf_task
from pmgt_tpu.tasks.interaction_base import TrainState
from pmgt_tpu_torch.core.config import TrainArgs as TArgs
from pmgt_tpu_torch.core.mesh import chunk_eval_inputs
from pmgt_tpu_torch.data import interactions as tint
from pmgt_tpu_torch.models.interop import dcn_params_from_flax, ncf_params_from_flax
from pmgt_tpu_torch.tasks import dcn_task, ncf_task

NUM_USERS, NUM_ITEMS = 200, 100
BATCH = 64
PARAM_TOL = 1e-5
AUC_TOL = 1e-6
# tools/dcn_sensitivity.py:119-136 with the two dropouts at 0
DCN_EXTRA = dict(factor_num=32, deep_net_num_layers=2, cross_net_num_layers=3, num_ng=1,
                 max_sample_items=5, emb_dropout=0.0, dropout=0.0, use_layer_norm=True)
NCF_EXTRA = dict(factor_num=8, num_layers=3, num_ng=1, max_sample_items=10, dropout=0.0)
CASES = {  # kind: (JAX module, port module, class, extra, converter, frozen table, width)
    "dcn": (jdcn_task, dcn_task, "DCNTask", DCN_EXTRA, dcn_params_from_flax,
            "item_embeddings", 32 * 2 ** 2),
    "ncf": (jncf_task, ncf_task, "NCFTask", NCF_EXTRA, ncf_params_from_flax,
            "embed_item_MLP", 8 * 2 ** 2),
}
NO_TABLES = types.SimpleNamespace(item_classes=None, node_classes=None)


def _splits(mod):
    """(train, valid, test) ``InteractionData`` of ``mod`` (the JAX or the
    port module) from one seeded draw: 3-7 items a user, two held out."""
    rng = np.random.default_rng(0)
    parts = ([], [], [])
    for u in range(NUM_USERS):
        items = rng.choice(NUM_ITEMS, size=rng.integers(5, 10), replace=False)
        parts[0].extend((u, i) for i in items[2:])
        parts[1].append((u, items[0]))
        parts[2].append((u, items[1]))
    return tuple(mod.InteractionData.build(np.asarray(p, np.int32), NUM_USERS, NUM_ITEMS)
                 for p in parts)


def _pair(kind, freeze, tmp_path):
    """(JAX task, port task on the CPU from the JAX task's parameters, the
    injected table as the JAX task holds it) for ``kind``."""
    jmod, tmod, name, extra, convert, table, width = CASES[kind]
    emb = np.random.default_rng(1).normal(size=(NUM_ITEMS, width)).astype(np.float32)
    np.save(tmp_path / "emb.npy", emb)
    e = dict(extra, item_init_emb_path=str(tmp_path / "emb.npy"), freeze_item_init_emb=freeze,
             normalize_item_init_emb=kind == "dcn")
    kw = dict(model_name="DCN" if kind == "dcn" else "NeuMF-end", dataset_name="syn", seed=0,
              num_epochs=12, train_batch_size=BATCH, test_batch_size=128, lr=1e-3,
              decay=1e-3, gradient_max_norm=5.0)
    jt = getattr(jmod, name)(JArgs(num_devices=1, extra=dict(e), **kw), NO_TABLES,
                             *_splits(jint))
    tt = getattr(tmod, name)(TArgs(extra=dict(e), **kw), NO_TABLES, *_splits(tint),
                             device="cpu")
    params = jax.device_get(jt.state.params)
    tt.model.load_state_dict(convert(params))
    return jt, tt, convert, np.asarray(params[table]["embedding"])


def _train_f64(jt, tt):
    """One epoch of each task on the JAX task's epoch-0 arrays, in f64 on
    both sides; (JAX losses, port losses, JAX parameters)."""
    jt.on_epoch_start(0)
    tt._epoch_arrays = tuple(torch.as_tensor(a) for a in jt._epoch_arrays)
    tt._epoch_arrays_epoch = 0
    tt.model.double()
    with jax.enable_x64(True):
        params = jax.tree.map(lambda x: jnp.asarray(np.asarray(x), jnp.float64),
                              jax.device_get(jt.state.params))
        state, jlosses = jt.train_epoch(TrainState(params, jt.tx.init(params)), 0)
        jlosses, jparams = np.asarray(jlosses), jax.device_get(state.params)
    tlosses = tt.train_epoch(0).numpy()
    tt.model.float()
    return jlosses, tlosses, jparams


def _inject_jax_candidates(jt, tt, split):
    """The JAX NCF task's candidate draw for ``split`` in the port task's
    evaluation cache."""
    data = jt.valid_data if split == "valid" else jt.test_data
    key = jax.random.key(np.uint32(jt.args.seed * 17 + (split == "test")))
    users, cands, mask, labels = jint.build_eval_candidates(
        data, jt.args.extra["max_sample_items"], key)
    arrays = chunk_eval_inputs(tt.eval_chunk_users, (users, cands, mask, labels))
    tt._eval_cache[split] = (len(users), [
        torch.as_tensor(a, dtype=dt) for a, dt in
        zip(arrays, (torch.int64, torch.int64, torch.float32, torch.float32))])


@pytest.mark.parametrize("freeze", [True, False], ids=["frozen", "trainable"])
@pytest.mark.parametrize("kind", ["dcn", "ncf"])
def test_one_epoch_matches_the_jax_package(kind, freeze, tmp_path):
    jt, tt, convert, injected = _pair(kind, freeze, tmp_path)
    table = CASES[kind][5]
    jlosses, tlosses, jparams = _train_f64(jt, tt)
    assert len(jlosses) == len(tlosses) >= 20
    np.testing.assert_allclose(tlosses, jlosses, rtol=0, atol=PARAM_TOL)
    want = convert(jparams)
    for n, p in tt.model.named_parameters():
        torch.testing.assert_close(p.detach().double(), want[n].double(), rtol=0,
                                   atol=PARAM_TOL, msg=n)
    # each package evaluates its own trained parameters, rounded to f32
    jstate = TrainState(jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), jparams),
                        jt.state.opt_state)
    trained = tt.model.state_dict()[f"{table}.weight"].numpy()
    moved = not np.array_equal(trained, injected)
    assert moved != freeze
    if freeze:  # bit-equal to the injected (normalised) rows in both packages
        np.testing.assert_array_equal(np.asarray(jparams[table]["embedding"]), injected)
    for split in ("valid", "test"):
        if kind == "dcn":
            tt.eval_arrays[split] = jt._eval_arrays[split]
        else:
            _inject_jax_candidates(jt, tt, split)
        want_m, got_m = jt.evaluate(jstate, split), tt.evaluate(split)
        assert set(got_m) == set(want_m)
        for k in want_m:
            assert abs(got_m[k] - want_m[k]) <= AUC_TOL, (split, k, got_m[k], want_m[k])
