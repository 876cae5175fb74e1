"""The port's downstream models against the JAX package's flax modules, on
the same numpy inputs, with the flax parameters loaded through the new
converters (``models/interop.py``).

- ``NCF`` in its four variants, with and without the layer-norm tower;
  ``DCN`` (with the layer norms and the cross bias as options);
  ``PMGT_NCF`` as MLP and NeuMF-end under both fusion strategies (its
  encoder on the kernel route, which on CPU tensors runs the plain
  versions). Each: the logits (tolerance 1e-6 · max(1, max|logit|), so
  1e-6 absolute on O(1) logits) and every parameter's gradient of the mean
  BCE (``jax.value_and_grad`` against autograd, the JAX gradient tree
  through the same converter; tolerance 1e-5 · max|g| of that parameter,
  + 1e-9 for gradients that are zero up to rounding), dropout off; DCN in
  float64 on both sides, the others in float32.
- ``fuse_neumf_params`` (the Dense tower layers copied, the LayerNorms
  left fresh, the blended predict layer) and ``inject_item_embeddings``:
  equal to the JAX functions' results after conversion.
- The initialisers: the sample moments of every parameter family of
  ``init_weights`` against the flax initialiser's distribution (mean,
  variance, bounds), within 6 standard errors.
- ``make_optimizer``'s ``frozen_names``: the frozen table leaves the decayed group.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmgt_tpu.core.config import PMGTConfig as JConfig
from pmgt_tpu.models import dcn as jdcn
from pmgt_tpu.models import ncf as jncf
from pmgt_tpu.models import pmgt_ncf as jpmgt_ncf
from pmgt_tpu_torch.core.config import PMGTConfig as TConfig
from pmgt_tpu_torch.models import dcn as tdcn
from pmgt_tpu_torch.models import ncf as tncf
from pmgt_tpu_torch.models import pmgt_ncf as tpmgt_ncf
from pmgt_tpu_torch.models.interop import (
    dcn_params_from_flax,
    ncf_params_from_flax,
    pmgt_ncf_params_from_flax,
)
from pmgt_tpu_torch.models.pmgt import bce_with_logits
from pmgt_tpu_torch.train.optim import no_decay_mask

USERS, ITEMS, B = 19, 29, 24
LOGIT_TOL, GRAD_TOL = 1e-6, 1e-5


def _bce(logits, labels):
    return jnp.mean(jnp.maximum(logits, 0) - logits * labels + jnp.log1p(jnp.exp(-jnp.abs(logits))))


def _inputs(seed=0):
    rs = np.random.default_rng(seed)
    return (rs.integers(0, USERS, B).astype(np.int32), rs.integers(0, ITEMS, B).astype(np.int32),
            (rs.random(B) < 0.5).astype(np.float32))


def _hold(t_model, convert, j_apply, params, t_call, labels, f64=False):
    """Logits and gradients of the port's model (loaded with
    ``convert(params)``) against the flax module's. The predict bias is
    moved off 0 first: a logit of exactly 0 (behind a dead ReLU tower) is
    where the JAX loss's gradient is wrong (its ``abs`` has derivative 1
    at 0, so it gives -y for sigmoid(0) - y; the port gives the true
    value). ``f64``: both sides in float64 (``jax.enable_x64`` scoped to
    the call)."""
    head = "output_layer" if "output_layer" in params else "predict_layer"
    params = {**params, head: {**params[head], "bias": params[head]["bias"] + 0.1}}
    with jax.enable_x64(f64):
        if f64:
            params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), params)
            t_model.double()
        t_model.load_state_dict(convert(params))
        j_logits = np.asarray(j_apply(params))
        lab = jnp.asarray(labels, j_logits.dtype)
        loss_j, grads_j = jax.value_and_grad(lambda p: _bce(j_apply(p), lab))(params)
        want = convert(grads_j)
    t_logits = t_call(t_model)
    scale = max(1.0, float(np.abs(j_logits).max()))
    assert np.abs(t_logits.detach().numpy() - j_logits).max() <= LOGIT_TOL * scale
    loss_t = torch.mean(bce_with_logits(t_logits, torch.as_tensor(labels, dtype=t_logits.dtype)))
    loss_t.backward()
    assert abs(loss_t.item() - float(loss_j)) <= LOGIT_TOL * max(1.0, float(loss_j))
    got = dict(t_model.named_parameters())
    assert set(want) == set(got)
    for name, g in want.items():
        # the floor covers gradients that are zero up to rounding (the key
        # biases: a softmax ignores a shift common to every key)
        err = (got[name].grad.double() - g.double()).abs().max().item()
        assert err <= GRAD_TOL * g.abs().max().item() + 1e-9, (name, err, g.abs().max().item())


NCF_CASES = [(v, ln) for v in ("GMF", "MLP", "NeuMF-end", "NeuMF-pre") for ln in (False, True)]


@pytest.mark.parametrize("variant,layer_norm", NCF_CASES)
def test_ncf_forward_and_gradients_match(variant, layer_norm):
    users, items, labels = _inputs(1)
    kw = dict(user_num=USERS, item_num=ITEMS, factor_num=4, num_layers=3,
              use_layer_norm=layer_norm, model=variant)
    jm = jncf.NCF(**kw)
    params = jm.init(jax.random.key(3), jnp.asarray(users), jnp.asarray(items))["params"]
    # larger embeddings than the N(0, 0.01) init, so every term matters
    params = jax.tree.map(lambda x: x * 30 if x.ndim == 2 and x.shape[0] in (USERS, ITEMS)
                          else x, params)
    _hold(tncf.NCF(**kw), ncf_params_from_flax,
          lambda p: jm.apply({"params": p}, jnp.asarray(users), jnp.asarray(items)),
          params, lambda m: m(torch.as_tensor(users).long(), torch.as_tensor(items).long()),
          labels)


@pytest.mark.parametrize("layer_norm,cross_bias", [(False, False), (True, False), (False, True)])
def test_dcn_forward_and_gradients_match(layer_norm, cross_bias):
    users, items, labels = _inputs(2)
    kw = dict(user_num=USERS, item_num=ITEMS, factor_num=2, deep_net_num_layers=2,
              cross_net_num_layers=3, use_layer_norm=layer_norm, use_cross_bias=cross_bias)
    jm = jdcn.DCN(**kw)
    params = jm.init(jax.random.key(4), jnp.asarray(users), jnp.asarray(items))["params"]
    # f64: DCN's N(0, 1) embeddings grow through the cross layers, and f32
    # LayerNorm gradients of such activations differ by ~2e-5 · max|g|
    _hold(tdcn.DCN(**kw), dcn_params_from_flax,
          lambda p: jm.apply({"params": p}, jnp.asarray(users), jnp.asarray(items)),
          params, lambda m: m(torch.as_tensor(users).long(), torch.as_tensor(items).long()),
          labels, f64=True)


def _pmgt_ncf_inputs(seed, n_nodes=40, s=6):
    rs = np.random.default_rng(seed)
    tables = [rs.normal(size=(n_nodes + 2, f)).astype(np.float32) for f in (16, 8)]
    for t in tables:
        t[:2] = 0.0
    seqs = rs.integers(2, n_nodes + 2, size=(B, s)).astype(np.int32)
    n_ctx = rs.integers(0, s, size=B)
    mask = (np.arange(s)[None] <= n_ctx[:, None]).astype(np.float32)
    seqs = np.where(mask > 0, seqs, 0).astype(np.int32)
    return tables, seqs, mask


@pytest.mark.parametrize("variant", ["MLP", "NeuMF-end"])
@pytest.mark.parametrize("fusion", ["project_tables", "gather_rows"])
def test_pmgt_ncf_forward_and_gradients_match(variant, fusion):
    users, items, labels = _inputs(3)
    tables, seqs, mask = _pmgt_ncf_inputs(5)
    cfg = dict(hidden_size=32, feat_hidden_sizes=(16, 8), intermediate_size=32,
               num_hidden_layers=2, num_attention_heads=1, beta=0.5, fusion_strategy=fusion)
    kw = dict(user_num=USERS, item_num=ITEMS, factor_num=4, num_layers=3, model=variant)
    jm = jpmgt_ncf.PMGT_NCF(config=JConfig(attention_impl="xla", **cfg), **kw)
    j_tables = [jnp.asarray(t) for t in tables]
    args = (jnp.asarray(users), jnp.asarray(seqs), jnp.asarray(mask))
    params = jm.init(jax.random.key(6), j_tables, *args, item=jnp.asarray(items))["params"]
    tm = tpmgt_ncf.PMGT_NCF(config=TConfig(attention_impl="pallas", **cfg), **kw)
    t_tables = [torch.as_tensor(t) for t in tables]
    _hold(tm, pmgt_ncf_params_from_flax,
          lambda p: jm.apply({"params": p}, j_tables, *args, item=jnp.asarray(items)),
          params,
          lambda m: m(t_tables, torch.as_tensor(users).long(), torch.as_tensor(seqs).long(),
                      torch.as_tensor(mask), item=torch.as_tensor(items).long()),
          labels)


def test_pmgt_ncf_gmf_index_defaults_to_node_minus_two_clipped():
    """Without ``item``, the GMF branch indexes node id - 2, clipped to the
    table (node 0, a graph-absent item, lands on item 0), as in JAX."""
    users, _, _ = _inputs(4)
    tables, seqs, mask = _pmgt_ncf_inputs(7, n_nodes=ITEMS + 5)
    seqs[:3, 0] = [0, 1, ITEMS + 6]
    cfg = dict(hidden_size=32, feat_hidden_sizes=(16, 8), intermediate_size=32,
               num_hidden_layers=1, fusion_strategy="project_tables")
    kw = dict(user_num=USERS, item_num=ITEMS, factor_num=4, num_layers=2, model="NeuMF-end")
    jm = jpmgt_ncf.PMGT_NCF(config=JConfig(attention_impl="xla", **cfg), **kw)
    j_tables = [jnp.asarray(t) for t in tables]
    args = (jnp.asarray(users), jnp.asarray(seqs), jnp.asarray(mask))
    params = jm.init(jax.random.key(8), j_tables, *args)["params"]
    tm = tpmgt_ncf.PMGT_NCF(config=TConfig(**cfg), **kw)
    tm.load_state_dict(pmgt_ncf_params_from_flax(params))
    want = np.asarray(jm.apply({"params": params}, j_tables, *args))
    got = tm([torch.as_tensor(t) for t in tables], torch.as_tensor(users).long(),
             torch.as_tensor(seqs).long(), torch.as_tensor(mask)).detach().numpy()
    assert np.abs(got - want).max() <= LOGIT_TOL * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("layer_norm", [False, True])
def test_fuse_neumf_params_matches(layer_norm):
    users, items, _ = _inputs(5)
    inits = {}
    for i, variant in enumerate(("GMF", "MLP", "NeuMF-pre")):
        m = jncf.NCF(USERS, ITEMS, factor_num=4, num_layers=2, use_layer_norm=layer_norm,
                     model=variant)
        inits[variant] = m.init(jax.random.key(10 + i), jnp.asarray(users),
                                jnp.asarray(items))["params"]
    want = ncf_params_from_flax(jncf.fuse_neumf_params(
        dict(inits["NeuMF-pre"]), inits["GMF"], inits["MLP"], alpha=0.3))
    got = tncf.fuse_neumf_params(*(ncf_params_from_flax(inits[v])
                                   for v in ("NeuMF-pre", "GMF", "MLP")), alpha=0.3)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-7)
    if layer_norm:  # the NeuMF-pre tower's LayerNorms stay fresh
        fresh = ncf_params_from_flax(inits["NeuMF-pre"])
        torch.testing.assert_close(got["mlp_norms.0.weight"], fresh["mlp_norms.0.weight"])
    tncf.NCF(USERS, ITEMS, factor_num=4, num_layers=2, use_layer_norm=layer_norm,
             model="NeuMF-pre").load_state_dict(got)


def test_inject_item_embeddings_matches():
    users, items, _ = _inputs(6)
    m = jncf.NCF(USERS, ITEMS, factor_num=4, num_layers=3, model="NeuMF-end")
    params = m.init(jax.random.key(0), jnp.asarray(users), jnp.asarray(items))["params"]
    emb = np.random.default_rng(0).normal(size=(ITEMS, 16)).astype(np.float32)
    want = ncf_params_from_flax(jncf.inject_item_embeddings(dict(params), emb))
    got = tncf.inject_item_embeddings(ncf_params_from_flax(params), emb)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    with pytest.raises(ValueError):
        tncf.inject_item_embeddings(got, emb[:, :8])


def test_converters_refuse_another_architecture():
    users, items, _ = _inputs(7)
    m = jncf.NCF(USERS, ITEMS, factor_num=4, num_layers=2, model="GMF")
    params = m.init(jax.random.key(0), jnp.asarray(users), jnp.asarray(items))["params"]
    with pytest.raises(ValueError):
        dcn_params_from_flax(params)
    with pytest.raises(RuntimeError):  # a GMF tree into a NeuMF-end model
        tncf.NCF(USERS, ITEMS, factor_num=4, num_layers=2, model="NeuMF-end").load_state_dict(
            ncf_params_from_flax(params))


# ----------------------------------------------------------------------
# initialisers
# ----------------------------------------------------------------------

def _moments_ok(x: np.ndarray, var: float, bound: float = None):
    """Sample mean and variance within 6 standard errors of (0, var); all
    values within ``bound``."""
    x = np.asarray(x, np.float64).ravel()
    n = len(x)
    assert abs(x.mean()) <= 6 * math.sqrt(var / n)
    fourth = np.mean(x ** 4)
    assert abs(x.var() - var) <= 6 * math.sqrt(max(fourth - var ** 2, 1e-30) / n)
    if bound is not None:
        assert np.abs(x).max() <= bound * (1 + 1e-6)


def test_ncf_initialisers():
    m = tncf.NCF(3000, 2000, factor_num=32, num_layers=3, model="NeuMF-end")
    m.init_weights(torch.Generator().manual_seed(0))
    for name in ("embed_user_GMF", "embed_item_GMF", "embed_user_MLP", "embed_item_MLP"):
        _moments_ok(getattr(m, name).weight.detach().numpy(), 0.01 ** 2)
    for lin in m.mlp_layers:
        fan_out, fan_in = lin.weight.shape
        bound = math.sqrt(6 / (fan_in + fan_out))
        _moments_ok(lin.weight.detach().numpy(), bound ** 2 / 3, bound)
        assert not lin.bias.detach().any()
    w = m.predict_layer.weight.detach().numpy()
    _moments_ok(w, 1 / w.shape[1], math.sqrt(3 / w.shape[1]))
    # the flax initialisers' own samples of the same shapes agree
    fp = jncf.NCF(3000, 2000, factor_num=32, num_layers=3).init(
        jax.random.key(0), jnp.zeros(2, jnp.int32), jnp.zeros(2, jnp.int32))["params"]
    _moments_ok(np.asarray(fp["embed_user_MLP"]["embedding"]), 0.01 ** 2)
    _moments_ok(np.asarray(fp["predict_layer"]["kernel"]), 1 / w.shape[1],
                math.sqrt(3 / w.shape[1]))


def test_dcn_and_pmgt_ncf_initialisers():
    m = tdcn.DCN(2000, 2000, factor_num=16, deep_net_num_layers=3, cross_net_num_layers=3,
                 use_cross_bias=True)
    m.init_weights(torch.Generator().manual_seed(1))
    _moments_ok(m.user_embeddings.weight.detach().numpy(), 1.0)
    for layer in m.cross_net.layers:
        _moments_ok(np.concatenate([layer.weight.detach().numpy().ravel(),
                                    layer.bias.detach().numpy()]), 1 / 3, 1.0)
    for lin in (*m.deep_net.layers, m.output_layer):
        w = lin.weight.detach().numpy()
        std = math.sqrt(1 / w.shape[1])
        # flax lecun_normal: variance 1/fan_in after truncation at 2 std / 0.8796
        if w.size > 1000:
            _moments_ok(w, std ** 2, 2 * std / 0.87962566103423978)
        assert not lin.bias.detach().any()
    fp = jdcn.DCN(2000, 2000, factor_num=16).init(
        jax.random.key(1), jnp.zeros(2, jnp.int32), jnp.zeros(2, jnp.int32))["params"]
    k = np.asarray(fp["deep_net"]["deep_0"]["kernel"])
    _moments_ok(k, 1 / k.shape[0], 2 * math.sqrt(1 / k.shape[0]) / 0.87962566103423978)

    cfg = TConfig(hidden_size=128, feat_hidden_sizes=(64, 32), num_hidden_layers=2)
    pm = tpmgt_ncf.PMGT_NCF(2000, 3000, cfg, factor_num=32, num_layers=3, model="NeuMF-end")
    pm.init_weights(torch.Generator().manual_seed(2))
    _moments_ok(pm.bert.layers[0].intermediate.weight.detach().numpy(), 0.02 ** 2)
    _moments_ok(pm.gmf_item_embeddings.weight.detach().numpy(), 0.01 ** 2)
    w = pm.mlp_layers[0].weight.detach().numpy()
    bound = math.sqrt(6 / sum(w.shape))
    _moments_ok(w, bound ** 2 / 3, bound)


def test_make_optimizer_frozen_names_take_tables_out_of_decay():
    from pmgt_tpu_torch.train.optim import make_optimizer

    m = tncf.NCF(5, 7, factor_num=4, num_layers=2, use_layer_norm=True, model="NeuMF-end")
    names = {id(p): n for n, p in m.named_parameters()}

    def decayed(opt):
        return {names[id(p)] for g in opt.inner.param_groups if g["weight_decay"] > 0
                for p in g["params"]}

    plain = decayed(make_optimizer(m, decay=0.1))
    frozen = decayed(make_optimizer(m, decay=0.1, frozen_names=("embed_item_MLP",)))
    assert plain == {n for n, d in no_decay_mask(m).items() if d}
    assert "embed_item_MLP.weight" in plain and frozen == plain - {"embed_item_MLP.weight"}
    assert "mlp_layers.0.bias" not in plain and "mlp_norms.0.weight" not in plain
