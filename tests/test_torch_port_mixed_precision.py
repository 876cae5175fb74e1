"""The bf16 compute policy (``--mp-enabled``) of the port against flax's
bf16 run of the JAX package.

Both sides hold f32 parameters (flax's through ``params_from_flax``) and
compute in bf16 on the same numpy inputs; the Pallas route of JAX runs in
interpret mode, the port's kernel route runs the kernels' plain versions
on the CPU (f32 math on bf16 operands, as the kernels). The model-level
tests run flax op by op (``apply`` outside ``jit``), where each bf16 op
rounds as the port's does; under ``jit`` (the JAX task) XLA on the CPU
fuses bf16 elementwise chains in f32 and rounds once, so the task-level
limits are wider. Limits, held over several seeds:

- encoder states: mean |port − JAX| <= 2e-4 and max <= 1e-2·max|JAX|
  (measured: mean <= 7.3e-5, max <= 2.6e-3 of max|JAX|);
- pre-training loss within 1e-3 relative, GSR logits within 4e-3 (one
  bf16 ulp at 1 is 7.8e-3); every parameter's gradient within
  5e-2·max|g_p| + 1e-2·max over all |g| of ``jax.value_and_grad``'s
  (measured: <= 3.6e-2 of that scale); the key biases' gradients, zero up
  to rounding (a softmax ignores a shift of every score), are held to the
  second term alone;
- a port that computed in f32 under the policy would sit at JAX's own
  f32-to-bf16 gap (mean 4.2e-3 to 4.9e-3 here, about 100x the bf16
  port's): the test of that gap fails it, and the dtypes at the layer
  boundaries are checked;
- ``PMGT_NCF`` logits (f32 after the tower) within 5e-3 of JAX's;
- ``PMGTTask`` evaluate (AUC within 5e-3, loss within 1e-3 relative) and
  export (mean |diff| <= 8e-3, max <= 3e-2·max|JAX|; measured 4.2e-3 and
  1.5e-2: the jitted JAX export's fusion) on JAX's phase tables.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from pmgt_tpu.core.config import PMGTConfig as JPMGTConfig
from pmgt_tpu.core.config import TrainArgs as JTrainArgs
from pmgt_tpu.data import artifacts as jartifacts
from pmgt_tpu.data import synthetic as jsynthetic
from pmgt_tpu.models.pmgt import PMGTForPreTraining as JPMGT
from pmgt_tpu.models.pmgt_ncf import PMGT_NCF as JPMGT_NCF
from pmgt_tpu.sampling.pairs import PretrainBatch as JBatch
from pmgt_tpu.tasks import pmgt_task as jtask_mod
from pmgt_tpu_torch.core.config import PMGTConfig, TrainArgs
from pmgt_tpu_torch.data import artifacts as tartifacts
from pmgt_tpu_torch.models.interop import params_from_flax, pmgt_ncf_params_from_flax
from pmgt_tpu_torch.models.pmgt import PMGTForPreTraining
from pmgt_tpu_torch.models.pmgt_ncf import PMGT_NCF
from pmgt_tpu_torch.sampling.pairs import PretrainBatch
from pmgt_tpu_torch.tasks import pmgt_task as ttask_mod

NODE_SIZE = 60
FEAT_DIMS = (64, 32)
SEQ = 6
SMALL = dict(hidden_size=32, intermediate_size=48, num_hidden_layers=2,
             num_attention_heads=1, feat_hidden_sizes=FEAT_DIMS)


def _tables(rs):
    tables = [rs.standard_normal((NODE_SIZE + 2, f)).astype(np.float32) for f in FEAT_DIMS]
    for t in tables:
        t[:2] = 0.0
    return tables


def _sequences(rs, n):
    ids = rs.integers(2, NODE_SIZE + 2, size=(n, SEQ)).astype(np.int32)
    n_ctx = rs.integers(0, SEQ, size=n)
    mask = (np.arange(SEQ)[None, :] <= n_ctx[:, None]).astype(np.float32)
    return np.where(mask > 0, ids, 0).astype(np.int32), mask


def _setup(seed, dtype, impl="pallas", fusion="project_tables"):
    """(flax model, its params, port model with them, tables, rs)."""
    rs = np.random.default_rng(seed)
    tables = _tables(rs)
    jm = JPMGT(config=JPMGTConfig(**SMALL, dtype=dtype, attention_impl=impl,
                                  fusion_strategy=fusion), node_size=NODE_SIZE)
    b, p = 2, 3
    dummy = JBatch(jnp.zeros((b, SEQ), jnp.int32), jnp.ones((b, SEQ)),
                   jnp.zeros((b, p, SEQ), jnp.int32), jnp.ones((b, p, SEQ)),
                   jnp.zeros((b, p)), jnp.ones((b, p)))
    rngs = {k: jax.random.key(i + seed) for i, k in
            enumerate(("params", "dropout", "corruption"))}
    params = jm.init(rngs, [jnp.asarray(t) for t in tables], dummy,
                     deterministic=False)["params"]
    params = jax.tree.map(np.asarray, params)
    model = PMGTForPreTraining(PMGTConfig(**SMALL, dtype=dtype, attention_impl=impl,
                                          fusion_strategy=fusion), NODE_SIZE)
    model.load_state_dict(params_from_flax(params), strict=True)
    return jm, params, model, tables, rs


def _encode_both(jm, params, model, tables, ids, mask):
    want = np.asarray(jm.apply({"params": params}, [jnp.asarray(t) for t in tables],
                               jnp.asarray(ids), jnp.asarray(mask), deterministic=True,
                               method=JPMGT.encode), np.float32)
    with torch.no_grad():
        got = model.encode([torch.from_numpy(t) for t in tables],
                           torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(mask))
    return got, want


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("fusion", ["project_tables", "gather_rows"])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_encoder_bf16_matches_flax(seed, fusion, impl):
    jm, params, model, tables, rs = _setup(seed, "bfloat16", impl, fusion)
    ids, mask = _sequences(rs, 16)
    got, want = _encode_both(jm, params, model, tables, ids, mask)
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - want)
    assert diff.mean() <= 2e-4, diff.mean()
    assert diff.max() <= 1e-2 * np.abs(want).max(), diff.max()


def _corruption_draws(jm, params, key, b):
    """The uniforms and ids JAX's ``_corrupt`` draws under ``key``."""
    ck = jm.apply({"params": params}, method=lambda m: m.make_rng("corruption"),
                  rngs={"corruption": key})
    r_replace, r_ids, r_mask = jax.random.split(ck, 3)
    shape = (b, SEQ - 1)
    return (torch.from_numpy(np.asarray(jax.random.uniform(r_replace, shape))),
            torch.from_numpy(np.asarray(jax.random.randint(
                r_ids, shape, 2, NODE_SIZE + 2, dtype=jnp.int32)).astype(np.int64)),
            torch.from_numpy(np.asarray(jax.random.uniform(r_mask, shape))))


def _pretrain_both(seed, impl, dtype="bfloat16"):
    """Loss, outputs and gradients of JAX (``value_and_grad``) and of the
    port (autograd) for one batch with NFR, dropout off."""
    jm, params, model, tables, rs = _setup(seed, dtype, impl)
    b, p = 4, 3
    t_ids, t_mask = _sequences(rs, b)
    p_ids, p_mask = _sequences(rs, b * p)
    labels = np.zeros((b, p), np.float32)
    labels[:, 0] = 1.0
    valid = np.ones((b, p), np.float32)
    arrays = (t_ids, t_mask, p_ids.reshape(b, p, SEQ), p_mask.reshape(b, p, SEQ), labels, valid)
    jt = [jnp.asarray(t) for t in tables]
    key = jax.random.key(seed + 100)

    def jloss(prm):
        out = jm.apply({"params": prm}, jt, JBatch(*map(jnp.asarray, arrays)),
                       deterministic=True, compute_nfr=True, rngs={"corruption": key})
        return out.loss, out

    (jl, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    batch = PretrainBatch(*(torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32 else a)
                            for a in arrays))
    out = model([torch.from_numpy(t) for t in tables], batch, deterministic=True,
                compute_nfr=True, corruption=_corruption_draws(jm, params, key, b))
    out.loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return out, jout, float(jl), grads, params_from_flax(jax.tree.map(np.asarray, jgrads))


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_pretraining_loss_and_gradients_bf16_match_flax(seed, impl):
    out, jout, jl, grads, want = _pretrain_both(seed, impl)
    assert out.loss.dtype == torch.float32 and out.logits.dtype == torch.bfloat16
    assert abs(float(out.loss.detach()) - jl) <= 1e-3 * abs(jl)
    np.testing.assert_allclose(out.logits.detach().float().numpy(),
                               np.asarray(jout.logits, np.float32), atol=4e-3)
    gmax = max(float(g.abs().max()) for g in want.values())
    for name, g in grads.items():
        assert g.dtype == torch.float32, name  # f32 parameters get f32 gradients
        w = want[name]
        scale = 0.0 if name.endswith("key.bias") else 5e-2 * float(w.abs().max())
        err = float((g - w).abs().max())
        assert err <= scale + 1e-2 * gmax, (name, err, scale, gmax)


def test_an_f32_port_under_the_policy_fails():
    """The dtypes at the layer boundaries are bf16, and an encoder that ran
    in f32 under the policy would miss JAX's bf16 states by far more than
    the bf16 port does (and than the limit of the parity test)."""
    jm, params, model, tables, rs = _setup(0, "bfloat16")
    ids, mask = _sequences(rs, 16)
    got, want = _encode_both(jm, params, model, tables, ids, mask)
    f32 = PMGTForPreTraining(dataclasses.replace(model.config, dtype="float32"), NODE_SIZE)
    f32.load_state_dict(model.state_dict())
    with torch.no_grad():
        got32 = f32.encode([torch.from_numpy(t) for t in tables],
                           torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(mask))
    gap16 = np.abs(got.float().numpy() - want).mean()
    gap32 = np.abs(got32.numpy() - want).mean()
    assert gap32 > 2e-4 >= gap16 and gap32 > 20 * gap16, (gap16, gap32)

    # boundary dtypes: projections, embeddings, every layer, the attention
    t = [torch.from_numpy(x) for x in tables]
    idt = torch.from_numpy(ids.astype(np.int64))
    with torch.no_grad():
        proj = model.project_tables(t)
        _, aux = model.bert([x[idt] for x in proj], torch.from_numpy(mask), True, True,
                            output_hidden_states=True, output_attentions=True)
    assert all(x.dtype == torch.bfloat16 for x in proj)
    assert all(x.dtype == torch.bfloat16 for x in aux["hidden_states"] + aux["attentions"])
    assert all(p.dtype == torch.float32 for p in model.parameters())
    seen = []
    hook = model.bert.layers[0].self_attention.register_forward_hook(
        lambda mod, inp, out: seen.append((inp[0].dtype, inp[1].dtype, out[0].dtype)))
    try:
        with torch.no_grad():
            model.encode(t, idt, torch.from_numpy(mask))
    finally:
        hook.remove()
    assert seen == [(torch.bfloat16,) * 3]
    # the additive mask is finfo(bf16).min
    from pmgt_tpu_torch.models.pmgt import _additive_mask
    m = _additive_mask(torch.tensor([[1.0, 0.0]]), torch.bfloat16)
    assert m.dtype == torch.bfloat16 and float(m[0, 1]) == float(torch.finfo(torch.bfloat16).min)


@pytest.mark.parametrize("model_name", ["MLP", "NeuMF-end"])
def test_pmgt_ncf_forward_bf16_matches_flax(model_name):
    rs = np.random.default_rng(5)
    tables = _tables(rs)
    jcfg = JPMGTConfig(**SMALL, dtype="bfloat16", attention_impl="pallas")
    jm = JPMGT_NCF(user_num=7, item_num=NODE_SIZE, config=jcfg, factor_num=8,
                   num_layers=2, model=model_name)
    jt = [jnp.asarray(t) for t in tables]
    ids, mask = _sequences(rs, 12)
    users = rs.integers(0, 7, size=12).astype(np.int32)
    items = (ids[:, 0] - 2).astype(np.int32)
    params = jm.init({"params": jax.random.key(1)}, jt, jnp.asarray(users), jnp.asarray(ids),
                     jnp.asarray(mask), jnp.asarray(items), deterministic=True)["params"]
    want = np.asarray(jm.apply({"params": params}, jt, jnp.asarray(users), jnp.asarray(ids),
                               jnp.asarray(mask), jnp.asarray(items), deterministic=True))
    model = PMGT_NCF(7, NODE_SIZE, PMGTConfig(**SMALL, dtype="bfloat16", attention_impl="pallas"),
                     factor_num=8, num_layers=2, model=model_name)
    model.load_state_dict(pmgt_ncf_params_from_flax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = model([torch.from_numpy(t) for t in tables], torch.from_numpy(users.astype(np.int64)),
                    torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(mask),
                    item=torch.from_numpy(items.astype(np.int64)))
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    np.testing.assert_allclose(got.numpy(), want, atol=5e-3)


DATA = dict(num_nodes=150, num_users=40, feat_dims=(64, 32), avg_degree=6,
            interactions_per_user=3, seed=0)
# both tasks on the kernel route (JAX's Pallas kernels in interpret mode)
EXTRA = dict(hidden_size=32, intermediate_size=32, num_hidden_layers=2, attention_impl="pallas")


@pytest.fixture(scope="module")
def mp_tasks(tmp_path_factory):
    """(JAX task, port task on the CPU) under ``mp_enabled``, sharing data,
    split and weights."""
    d = tmp_path_factory.mktemp("data")
    jart = jsynthetic.make_synthetic_dataset(**DATA)
    jartifacts.save_native(str(d / "SYN"), jart)
    tart = tartifacts.load_artifacts(str(d), "SYN")
    jargs = JTrainArgs(seed=3, test_batch_size=32, train_batch_size=16, mp_enabled=True,
                       extra=dict(EXTRA))
    jctx = {"artifacts": jart}
    jtask_mod.init_dataloader(jargs, jctx)
    jtask = jtask_mod.PMGTTask(jargs, jart, jctx["train_nodes"], jctx["valid_nodes"])
    targs = TrainArgs(seed=3, test_batch_size=32, train_batch_size=16, mp_enabled=True,
                      extra=dict(EXTRA))
    tctx = {"artifacts": tart}
    ttask_mod.init_dataloader(targs, tctx)
    ttask = ttask_mod.PMGTTask(targs, tart, tctx["train_nodes"], tctx["valid_nodes"],
                               device="cpu")
    ttask.model.load_state_dict(params_from_flax(jtask.state.params), strict=True)
    return jtask, ttask


def _share_phase_tables(jtask, ttask, tag):
    ids, mask, pairs = jtask._get_ctx(tag)
    to_t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    ttask._phase_ctx_cache[tag] = (
        to_t(ids).long(), to_t(mask),
        None if pairs is None else (to_t(pairs[0]).long(), to_t(pairs[1]), to_t(pairs[2])),
    )


def test_task_policy_and_tables(mp_tasks):
    jtask, ttask = mp_tasks
    assert ttask.config.dtype == "bfloat16" == jtask.config.dtype
    for a, b in zip(ttask.feat_tables, jtask.feat_tables, strict=True):
        assert a.dtype == torch.bfloat16 and b.dtype == ml_dtypes.bfloat16
        np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                      np.asarray(b).view(np.int16))


def test_task_evaluate_bf16_matches_jax(mp_tasks):
    jtask, ttask = mp_tasks
    _share_phase_tables(jtask, ttask, ("valid",))
    want = jtask.evaluate(jtask.state, "valid")
    got = ttask.evaluate("valid")
    assert abs(got["val/auc"] - want["val/auc"]) <= 5e-3, (got, want)
    assert abs(got["val/loss"] - want["val/loss"]) <= 1e-3 * abs(want["val/loss"]), (got, want)


def test_task_export_bf16_matches_jax(mp_tasks):
    jtask, ttask = mp_tasks
    _share_phase_tables(jtask, ttask, ("inference",))
    want = jtask.export_embeddings(jtask.state.params)
    got = ttask.export_embeddings()
    assert got.dtype == np.float32 and got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.mean() <= 8e-3 and diff.max() <= 3e-2 * np.abs(want).max(), (diff.mean(), diff.max())


def test_task_trains_a_cpu_step_in_bf16(mp_tasks):
    _, ttask = mp_tasks
    before = {n: p.detach().clone() for n, p in ttask.model.named_parameters()}
    losses = ttask.train_epoch(0)
    assert losses.dtype == torch.float32 and torch.isfinite(losses).all() and len(losses) > 0
    moved = [n for n, p in ttask.model.named_parameters() if not torch.equal(p, before[n])]
    assert moved and all(p.dtype == torch.float32 for p in ttask.model.parameters())
