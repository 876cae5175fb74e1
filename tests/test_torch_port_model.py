"""Parity of the port's PMGT encoder and GSR head with the Flax model.

Weights come from ``PMGTForPreTraining.init`` in the JAX package and are
loaded into the port through ``params_from_flax``; both sides then run on
the same numpy node-id sequences. Encoder hidden states, CLS rows and GSR
logits/loss must agree to f32 tolerance (atol 2e-5), for both fusion
dataflows and both attention routes.
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
from pmgt_tpu.sampling.pairs import PretrainBatch as JBatch
from pmgt_tpu_torch.core.config import PMGTConfig
from pmgt_tpu_torch.models.interop import params_from_flax
from pmgt_tpu_torch.models.pmgt import PMGTForPreTraining
from pmgt_tpu_torch.sampling.pairs import PretrainBatch

ATOL = 2e-5
NODE_SIZE = 60
FEAT_DIMS = (64, 32)
SEQ = 6
SMALL = dict(hidden_size=32, intermediate_size=48, num_hidden_layers=2,
             num_attention_heads=2, feat_hidden_sizes=FEAT_DIMS)


def _jax_params(cfg):
    model = JPMGT(config=cfg, node_size=NODE_SIZE)
    b, p = 2, 3
    dummy = JBatch(
        target_ids=jnp.zeros((b, SEQ), jnp.int32),
        target_mask=jnp.ones((b, SEQ), jnp.float32),
        pair_ids=jnp.zeros((b, p, SEQ), jnp.int32),
        pair_mask=jnp.ones((b, p, SEQ), jnp.float32),
        labels=jnp.zeros((b, p), jnp.float32),
        pair_valid=jnp.ones((b, p), jnp.float32),
    )
    tables = [jnp.zeros((NODE_SIZE + 2, f)) for f in FEAT_DIMS]
    rngs = {k: jax.random.key(i) for i, k in
            enumerate(("params", "dropout", "corruption"))}
    params = model.init(rngs, tables, dummy, deterministic=False)["params"]
    return model, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def setup():
    rs = np.random.default_rng(0)
    tables = [rs.standard_normal((NODE_SIZE + 2, f)).astype(np.float32)
              for f in FEAT_DIMS]
    for t in tables:
        t[:2] = 0.0
    jcfg = JPMGTConfig(**SMALL)
    jmodel, params = _jax_params(jcfg)
    return jmodel, params, tables


def _port_model(params, **overrides):
    cfg = PMGTConfig(**{**SMALL, **overrides})
    model = PMGTForPreTraining(cfg, NODE_SIZE)
    model.load_state_dict(params_from_flax(params), strict=True)
    return model.eval()


def _sequences(rs, batch):
    ids = rs.integers(2, NODE_SIZE + 2, size=(batch, SEQ)).astype(np.int32)
    n_ctx = rs.integers(0, SEQ, size=batch)
    mask = (np.arange(SEQ)[None, :] <= n_ctx[:, None]).astype(np.float32)
    ids = np.where(mask > 0, ids, 0).astype(np.int32)
    return ids, mask


@pytest.mark.parametrize("fusion", ["project_tables", "gather_rows"])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_encode_matches_flax(setup, fusion, impl):
    jmodel, params, tables = setup
    jm = jmodel.clone(config=dataclasses.replace(
        jmodel.config, fusion_strategy=fusion, attention_impl=impl))
    ids, mask = _sequences(np.random.default_rng(1), 9)
    want = np.asarray(jm.apply(
        {"params": params}, [jnp.asarray(t) for t in tables],
        jnp.asarray(ids), jnp.asarray(mask), deterministic=True,
        method=JPMGT.encode,
    ))
    model = _port_model(params, fusion_strategy=fusion, attention_impl=impl)
    with torch.no_grad():
        got = model.encode(
            [torch.from_numpy(t) for t in tables],
            torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(mask),
        ).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got[:, 0], want[:, 0], atol=ATOL)  # CLS rows


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_gsr_logits_and_loss_match_flax(setup, impl):
    jmodel, params, tables = setup
    rs = np.random.default_rng(2)
    b, p = 5, 2
    t_ids, t_mask = _sequences(rs, b)
    p_ids, p_mask = _sequences(rs, b * p)
    labels = np.tile(np.array([[1.0, 0.0]], np.float32), (b, 1))
    valid = np.ones((b, p), np.float32)
    valid[0, 0] = 0.0  # an isolated target's positive slot
    arrays = (t_ids, t_mask, p_ids.reshape(b, p, SEQ),
              p_mask.reshape(b, p, SEQ), labels, valid)
    jm = jmodel.clone(config=dataclasses.replace(jmodel.config, attention_impl=impl))
    out_j = jm.apply(
        {"params": params}, [jnp.asarray(t) for t in tables],
        JBatch(*(jnp.asarray(a) for a in arrays)),
        deterministic=True, compute_nfr=False,
    )
    model = _port_model(params, attention_impl=impl)
    batch = PretrainBatch(*(
        torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32 else a)
        for a in arrays
    ))
    with torch.no_grad():
        out = model([torch.from_numpy(t) for t in tables], batch)
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(out_j.logits), atol=ATOL)
    np.testing.assert_allclose(out.target_cls.numpy(),
                               np.asarray(out_j.target_cls), atol=ATOL)
    np.testing.assert_allclose(float(out.gsr_loss), float(out_j.gsr_loss), atol=ATOL)
    assert float(out.nfr_loss) == 0.0 == float(out_j.nfr_loss)


def test_params_from_flax_rejects_missing_and_extra_leaves(setup):
    _, params, _ = setup
    state = params_from_flax(params)
    assert state["bert.layers.1.self_attention.query.weight"].shape == (32, 32)
    assert state["bert.embeddings.feat_linear.0.weight"].shape == (32, 64)
    np.testing.assert_array_equal(
        state["bert.layers.0.intermediate.weight"].numpy(),
        params["bert"]["layer_0"]["intermediate"]["kernel"].T,
    )
    missing = jax.tree.map(lambda x: x, params)
    del missing["bert"]["layer_1"]["attention_norm"]["scale"]
    with pytest.raises(ValueError, match="missing"):
        params_from_flax(missing)
    extra = jax.tree.map(lambda x: x, params)
    extra["bert"]["layer_0"]["self_attention"]["distance_embedding"] = np.zeros((3, 16))
    with pytest.raises(ValueError, match="extra"):
        params_from_flax(extra)


def test_unported_options_raise(setup):
    """Every model option of the JAX package is ported: values it does not
    have raise ValueError, and dropout and NFR raise ValueError without the
    generator they draw from."""
    _, params, tables = setup
    with pytest.raises(ValueError, match="position_embedding_type"):
        PMGTForPreTraining(PMGTConfig(**SMALL, position_embedding_type="rotary"), 4)
    with pytest.raises(ValueError, match="compute dtype"):
        PMGTForPreTraining(PMGTConfig(**SMALL, dtype="float16"), 4)
    with pytest.raises(ValueError, match="attention_impl"):
        PMGTForPreTraining(PMGTConfig(**SMALL, attention_impl="triton"), 4)
    model = _port_model(params)
    t = [torch.from_numpy(x) for x in tables]
    ids = torch.full((2, SEQ), 3)
    mask = torch.ones(2, SEQ)
    with pytest.raises(ValueError, match="Generator"):
        model.encode(t, ids, mask, deterministic=False)
    batch = PretrainBatch(ids, mask, ids[:, None], mask[:, None],
                          torch.ones(2, 1), torch.ones(2, 1))
    with pytest.raises(ValueError, match="Generator"):
        model(t, batch, compute_nfr=True)


@pytest.mark.parametrize("option", [
    dict(position_embedding_type="relative_key"), dict(dtype="bfloat16"),
    dict(gradient_checkpointing=True), "output_attentions", "head_mask",
])
def test_model_options_run(setup, option):
    """The options the model refused before run a training forward and
    backward on the CPU (their parity is in test_torch_port_model_options.py
    and test_torch_port_mixed_precision.py)."""
    _, _, tables = setup
    cfg = PMGTConfig(**SMALL, **(option if isinstance(option, dict) else {}))
    model = PMGTForPreTraining(cfg, NODE_SIZE)
    model.init_weights(torch.Generator().manual_seed(0))
    t = [torch.from_numpy(x) for x in tables]
    ids = torch.randint(2, NODE_SIZE + 2, (3, SEQ), generator=torch.Generator().manual_seed(1))
    mask = torch.ones(3, SEQ)
    gen = torch.Generator().manual_seed(2)
    if isinstance(option, dict):
        batch = PretrainBatch(ids, mask, ids[:, None], mask[:, None],
                              torch.ones(3, 1), torch.ones(3, 1))
        loss = model(t, batch, deterministic=False, compute_nfr=True, generator=gen).loss
    else:
        kw = ({"output_attentions": True} if option == "output_attentions"
              else {"head_mask": torch.tensor([1.0, 0.5])})
        out = model.bert([x[ids] for x in t], mask, False, generator=gen, **kw)
        hidden = out[0] if isinstance(out, tuple) else out
        loss = hidden.float().square().mean()
    loss.backward()
    assert bool(torch.isfinite(loss))
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for n, p in model.named_parameters() if n.startswith("bert.layers"))
