"""The encoder's options against the JAX package, float32 on the CPU:

- relative positions (``relative_key``, ``relative_key_query``): encoder
  states, the pre-training loss and every parameter gradient (the
  ``distance_embedding`` included) against flax and ``jax.value_and_grad``,
  within the f32 limits of ``test_torch_port_train.py`` (states 2e-5;
  gradients 1e-5 + 1e-4·max|g|), on both attention routes (both take the
  plain attention for a relative layer, as in JAX);
- ``head_mask`` of shape [L, h] and [h]; the ``aux`` dict
  (``hidden_states``: embeddings + each layer; ``attentions``: each
  layer's blended probs) against ``PMGTModel``'s;
- gradient checkpointing: with dropout on, the same loss and gradients bit
  for bit as without it under ``torch.use_deterministic_algorithms(True)``,
  the generator left where a forward without it leaves it, the forward
  kernel called 2·L times and the backward L times; and equal to JAX's
  ``nn.remat`` run (f32 limits), whose parameter tree converts unchanged;
- ``prune_attention_heads`` against JAX's at h = 4: the same pruned
  tensors and config, and the pruned models' states agree.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmgt_tpu.core.config import PMGTConfig as JPMGTConfig
from pmgt_tpu.models.pmgt import PMGTForPreTraining as JPMGT
from pmgt_tpu.models.pruning import prune_attention_heads as jprune
from pmgt_tpu.sampling.pairs import PretrainBatch as JBatch
from pmgt_tpu_torch.core.config import PMGTConfig
from pmgt_tpu_torch.models.interop import params_from_flax
from pmgt_tpu_torch.models.pmgt import PMGTForPreTraining
from pmgt_tpu_torch.models.pruning import prune_attention_heads
from pmgt_tpu_torch.ops import dual_attention as da
from pmgt_tpu_torch.sampling.pairs import PretrainBatch

ATOL = 2e-5
NODE_SIZE = 60
FEAT_DIMS = (64, 32)
SEQ = 6
SMALL = dict(hidden_size=32, intermediate_size=48, num_hidden_layers=2,
             num_attention_heads=2, feat_hidden_sizes=FEAT_DIMS, max_position_embeddings=8)


def _tables(seed=0):
    rs = np.random.default_rng(seed)
    tables = [rs.standard_normal((NODE_SIZE + 2, f)).astype(np.float32) for f in FEAT_DIMS]
    for t in tables:
        t[:2] = 0.0
    return tables


def _sequences(rs, n):
    ids = rs.integers(2, NODE_SIZE + 2, size=(n, SEQ)).astype(np.int32)
    n_ctx = rs.integers(0, SEQ, size=n)
    mask = (np.arange(SEQ)[None, :] <= n_ctx[:, None]).astype(np.float32)
    return np.where(mask > 0, ids, 0).astype(np.int32), mask


def _batch_arrays(rs, b=4, p=3):
    t_ids, t_mask = _sequences(rs, b)
    p_ids, p_mask = _sequences(rs, b * p)
    labels = np.zeros((b, p), np.float32)
    labels[:, 0] = 1.0
    return (t_ids, t_mask, p_ids.reshape(b, p, SEQ), p_mask.reshape(b, p, SEQ), labels,
            np.ones((b, p), np.float32))


def _tbatch(arrays):
    return PretrainBatch(*(torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32 else a)
                           for a in arrays))


def _flax(cfg_kw, tables, seed=0):
    jm = JPMGT(config=JPMGTConfig(**cfg_kw), node_size=NODE_SIZE)
    arrays = _batch_arrays(np.random.default_rng(99), 2, 2)
    rngs = {k: jax.random.key(seed + i) for i, k in enumerate(("params", "dropout", "corruption"))}
    params = jm.init(rngs, [jnp.asarray(t) for t in tables], JBatch(*map(jnp.asarray, arrays)),
                     deterministic=False)["params"]
    return jm, jax.tree.map(np.asarray, params)


def _port(cfg_kw, params):
    model = PMGTForPreTraining(PMGTConfig(**cfg_kw), NODE_SIZE)
    model.load_state_dict(params_from_flax(params), strict=True)
    return model


def _grads_both(jm, params, model, tables, arrays):
    """GSR-only loss and gradients of both sides, dropout off."""
    jt = [jnp.asarray(t) for t in tables]

    def loss_fn(p):
        out = jm.apply({"params": p}, jt, JBatch(*map(jnp.asarray, arrays)),
                       deterministic=True, compute_nfr=False)
        return out.loss

    jl, jg = jax.value_and_grad(loss_fn)(params)
    out = model([torch.from_numpy(t) for t in tables], _tbatch(arrays), deterministic=True)
    out.loss.backward()
    return out, float(jl), params_from_flax(jax.tree.map(np.asarray, jg))


def _assert_grads(model, want):
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].grad
        g = torch.zeros_like(w) if g is None else g  # the NFR heads without NFR
        err = float((g - w).abs().max())
        tol = 1e-5 + 1e-4 * float(w.abs().max())
        assert err <= tol, (name, err, tol)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("kind", ["relative_key", "relative_key_query"])
def test_relative_positions_match_flax(kind, impl):
    tables = _tables()
    kw = dict(SMALL, position_embedding_type=kind, attention_impl=impl)
    jm, params = _flax(kw, tables)
    assert params["bert"]["layer_1"]["self_attention"]["distance_embedding"].shape == (15, 16)
    model = _port(kw, params)
    rs = np.random.default_rng(4)
    ids, mask = _sequences(rs, 9)
    want = np.asarray(jm.apply({"params": params}, [jnp.asarray(t) for t in tables],
                               jnp.asarray(ids), jnp.asarray(mask), method=JPMGT.encode))
    with torch.no_grad():
        got = model.encode([torch.from_numpy(t) for t in tables],
                           torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    out, jl, want_g = _grads_both(jm, params, model, tables, _batch_arrays(rs))
    assert abs(float(out.loss.detach()) - jl) <= ATOL
    _assert_grads(model, want_g)
    assert float(model.bert.layers[0].self_attention.distance_embedding.grad.abs().max()) > 0


def _bert_both(jm, params, model, tables, ids, mask, **kw):
    jt = [jnp.asarray(t) for t in tables]

    def run(m):
        proj = m.bert.project_tables(jt)
        return m.bert([t[jnp.asarray(ids)] for t in proj], jnp.asarray(mask), True,
                      projected=True, **kw)

    want = jm.apply({"params": params}, method=run)
    tt = [torch.from_numpy(t) for t in tables]
    with torch.no_grad():
        proj = model.project_tables(tt)
        got = model.bert([t[torch.from_numpy(ids.astype(np.int64))] for t in proj],
                         torch.from_numpy(mask), True, True, **kw)
    return got, want


@pytest.mark.parametrize("shape", ["layers_heads", "heads"])
def test_head_mask_matches_flax(shape):
    tables = _tables(1)
    kw = dict(SMALL, attention_impl="pallas")
    jm, params = _flax(kw, tables, seed=1)
    model = _port(kw, params)
    ids, mask = _sequences(np.random.default_rng(5), 7)
    hm = np.array([[1.0, 0.0], [0.5, 2.0]], np.float32) if shape == "layers_heads" \
        else np.array([0.0, 1.5], np.float32)
    got, want = _bert_both(jm, params, model, tables, ids, mask, head_mask=hm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want[0]), atol=ATOL)
    # a masked head changes the result
    plain, _ = _bert_both(jm, params, model, tables, ids, mask)
    assert float((plain - got).abs().max()) > 1e-3


def test_aux_outputs_match_flax():
    tables = _tables(2)
    kw = dict(SMALL, attention_impl="pallas")
    jm, params = _flax(kw, tables, seed=2)
    model = _port(kw, params)
    ids, mask = _sequences(np.random.default_rng(6), 5)
    (hidden, aux), want = _bert_both(jm, params, model, tables, ids, mask,
                                     output_hidden_states=True, output_attentions=True)
    jhidden, _, jaux = want
    assert set(aux) == set(jaux) == {"hidden_states", "attentions"}
    assert len(aux["hidden_states"]) == 3 and len(aux["attentions"]) == 2
    np.testing.assert_allclose(hidden.numpy(), np.asarray(jhidden), atol=ATOL)
    for a, b in zip(aux["hidden_states"], jaux["hidden_states"], strict=True):
        assert a.shape == (5, SEQ, 32)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    for a, b in zip(aux["attentions"], jaux["attentions"], strict=True):
        assert a.shape == (5, 2, SEQ, SEQ)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
        # every query row of the blended probs sums to 1 (no dropout)
        np.testing.assert_allclose(a.sum(-1).numpy(), 1.0, atol=1e-5)
    (_, only), _ = _bert_both(jm, params, model, tables, ids, mask, output_attentions=True)
    assert set(only) == {"attentions"}


def _count_kernel_calls(monkeypatch):
    """Count the forward and backward launches of the kernel route on the
    CPU (the counters on ``dual_attention_sm`` count card launches only)."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = da.dual_attention_sm_forward, da.dual_attention_sm_backward

    def counted_fwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def counted_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)

    monkeypatch.setattr(da, "dual_attention_sm_forward", counted_fwd)
    monkeypatch.setattr(da, "dual_attention_sm_backward", counted_bwd)
    return calls


def test_gradient_checkpointing_is_bit_equal_with_dropout(monkeypatch):
    tables = _tables(3)
    kw = dict(SMALL, attention_impl="pallas")
    _, params = _flax(kw, tables, seed=3)
    arrays = _batch_arrays(np.random.default_rng(7))
    calls = _count_kernel_calls(monkeypatch)
    runs = []
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for remat in (False, True):
            model = _port(dict(kw, gradient_checkpointing=remat), params)
            gen = torch.Generator().manual_seed(123)
            calls.update(fwd=0, bwd=0)
            out = model([torch.from_numpy(t) for t in tables], _tbatch(arrays),
                        deterministic=False, compute_nfr=True, generator=gen)
            out.loss.backward()
            runs.append((out, {n: p.grad.clone() for n, p in model.named_parameters()},
                         torch.rand(4, generator=gen), dict(calls)))
    finally:
        torch.use_deterministic_algorithms(prev)
    (o0, g0, after0, c0), (o1, g1, after1, c1) = runs
    layers = SMALL["num_hidden_layers"]
    assert c0 == {"fwd": layers, "bwd": layers} and c1 == {"fwd": 2 * layers, "bwd": layers}
    assert torch.equal(o0.loss, o1.loss) and float(o0.nfr_loss) > 0
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    assert torch.equal(after0, after1)  # the generator left where it would be


def test_gradient_checkpointing_matches_jax_remat():
    tables = _tables(4)
    kw = dict(SMALL, attention_impl="xla", gradient_checkpointing=True)
    jm, params = _flax(kw, tables, seed=4)
    assert sorted(params["bert"]) == ["embeddings", "layer_0", "layer_1"]
    model = _port(kw, params)
    out, jl, want = _grads_both(jm, params, model, tables,
                                _batch_arrays(np.random.default_rng(8)))
    assert abs(float(out.loss.detach()) - jl) <= ATOL
    _assert_grads(model, want)


def test_prune_attention_heads_matches_jax():
    tables = _tables(5)
    kw = dict(SMALL, num_attention_heads=4, attention_impl="pallas")
    jm, params = _flax(kw, tables, seed=5)
    heads = {0: [1, 3], 1: [0, 2]}
    jparams, jcfg = jprune(params, jm.config, heads)
    state, cfg = prune_attention_heads(params_from_flax(params), PMGTConfig(**kw), heads)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.num_attention_heads == 2 and cfg.head_dim == 8 and cfg.all_head_size == 16
    want = params_from_flax(jax.tree.map(np.asarray, jparams))
    assert set(state) == set(want)
    for n, w in want.items():
        assert torch.equal(state[n], w), n
    model = PMGTForPreTraining(cfg, NODE_SIZE)
    model.load_state_dict(state, strict=True)
    ids, mask = _sequences(np.random.default_rng(9), 6)
    jpm = jm.clone(config=jcfg)
    expect = np.asarray(jpm.apply({"params": jparams}, [jnp.asarray(t) for t in tables],
                                  jnp.asarray(ids), jnp.asarray(mask), method=JPMGT.encode))
    with torch.no_grad():
        got = model.encode([torch.from_numpy(t) for t in tables],
                           torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), expect, atol=ATOL)
    with pytest.raises(ValueError, match="same number"):
        prune_attention_heads(state, PMGTConfig(**kw), {0: [1], 1: [0, 2]})
    with pytest.raises(ValueError, match="all heads"):
        prune_attention_heads(state, PMGTConfig(**kw), {0: [0, 1, 2, 3], 1: [0, 1, 2, 3]})
