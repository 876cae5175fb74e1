"""``pmgt_tpu_torch.tools.tpu_precision``: the TPU's DEFAULT matmul
precision emulated for a bisect, on the CPU.

Inside ``tpu_default_precision()`` a DCN with the sensitivity tool's
layout (factor 32, deep 2, cross 3, layer norm) gives the logits and
gradients of a hand computation in which every product takes
bf16-rounded operands in f32 (the forward's, and in the backward the
incoming gradient rounded before both products), and each of its six
products a forward is counted. Outside it, the model's outputs and
gradients are bit-equal to the plain f32 path's, before and after.
"""
from __future__ import annotations

import numpy as np
import torch

from pmgt_tpu_torch.models.dcn import DCN
from pmgt_tpu_torch.models.pmgt import bce_with_logits
from pmgt_tpu_torch.tools.tpu_precision import bf16_matmul, bf16_round, tpu_default_precision

USERS, ITEMS, B = 50, 40, 64
TOL = 1e-6  # relative to the largest magnitude: f32 sums in another order


def _model():
    torch.manual_seed(0)
    m = DCN(USERS, ITEMS, factor_num=32, deep_net_num_layers=2, cross_net_num_layers=3,
            use_layer_norm=True)
    m.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():  # the frozen arm's rows: L2-normalised, entries ~0.088
        w = m.item_embeddings.weight
        w /= w.norm(dim=1, keepdim=True)
    return m


def _batch():
    rs = np.random.default_rng(1)
    return (torch.as_tensor(rs.integers(0, USERS, B)), torch.as_tensor(rs.integers(0, ITEMS, B)),
            torch.as_tensor((rs.random(B) < 0.5).astype(np.float32)))


def _st(x):
    """bf16-rounded forward, identity backward."""
    return x + (bf16_round(x) - x).detach()


def _hand_product(a, b):
    """``a @ b`` from rounded operands; the gradient arriving at the
    product is rounded before both backward products."""
    out = _st(a) @ _st(b)
    if out.requires_grad:
        out.register_hook(bf16_round)
    return out


def _hand_forward(m, users, items):
    """The DCN forward (models/dcn.py) written out, each product by hand."""
    x0 = torch.cat([m.user_embeddings(users), m.item_embeddings(items)], -1)
    x1 = x0
    for layer in m.cross_net.layers:
        x1 = layer.norm(x0 * _hand_product(x1, layer.weight) + x0)
    deep = x0
    for lin, norm in zip(m.deep_net.layers, m.deep_net.norms):
        deep = torch.relu(norm(_hand_product(deep, lin.weight.t()) + lin.bias))
    out = m.output_layer
    return (_hand_product(torch.cat([x1, deep], -1), out.weight.t()) + out.bias)[..., 0]


def _loss_and_grads(m, fn):
    m.zero_grad()
    users, items, labels = _batch()
    logits = fn(users, items)
    bce_with_logits(logits, labels).mean().backward()
    return logits.detach(), {n: p.grad.clone() for n, p in m.named_parameters()}


def _close(got, want):
    scale = max(want.abs().max().item(), 1e-30)
    assert (got - want).abs().max().item() <= TOL * scale, (got - want).abs().max().item()


def test_dcn_inside_equals_the_hand_computation_on_rounded_operands():
    m = _model()
    plain_logits, plain_grads = _loss_and_grads(m, m)
    with tpu_default_precision() as mode:
        logits, grads = _loss_and_grads(m, m)
    assert mode.calls == 6  # 3 cross products, 2 deep layers, the output layer
    want_logits, want_grads = _loss_and_grads(m, lambda u, i: _hand_forward(m, u, i))
    _close(logits, want_logits)
    for n, g in grads.items():
        _close(g, want_grads[n])
    # the rounding shows: the logits move by far more than f32 sums do
    assert (logits - plain_logits).abs().max() > 1e3 * TOL * plain_logits.abs().max()
    name = "deep_net.layers.0.weight"
    assert not torch.equal(grads[name], plain_grads[name])


def test_outside_the_model_is_the_plain_f32_path_to_the_bit():
    m = _model()
    before = _loss_and_grads(m, m)
    with tpu_default_precision():
        _loss_and_grads(m, m)
    after = _loss_and_grads(m, m)
    assert torch.equal(before[0], after[0])
    for n, g in before[1].items():
        assert torch.equal(g, after[1][n]), n
    assert not torch.backends.cuda.matmul.allow_tf32


def test_bf16_matmul_of_a_batch_of_rows():
    # leading dims flattened; products of bf16 values are exact in f32
    rs = np.random.default_rng(2)
    a = torch.tensor(rs.normal(size=(3, 5, 16)).astype(np.float32), requires_grad=True)
    b = torch.tensor(rs.normal(size=(16, 4)).astype(np.float32), requires_grad=True)
    out = bf16_matmul(a, b)
    want = bf16_round(a).double() @ bf16_round(b).double()
    assert out.shape == (3, 5, 4)
    _close(out.double(), want)
    g = torch.as_tensor(rs.normal(size=(3, 5, 4)).astype(np.float32))
    out.backward(g)
    g16 = bf16_round(g).double()
    _close(a.grad.double(), g16 @ bf16_round(b).double().t())
    _close(b.grad.double(), torch.einsum("bik,bin->kn", bf16_round(a).double(), g16))
