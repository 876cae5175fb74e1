"""Parity of the port's seq-major dual-attention backward (K2) with the JAX
package, and the autograd op that joins K1 and K2.

- ``dual_attention_sm_backward_reference`` (the plain PyTorch backward)
  against ``pmgt_tpu.ops.dual_attention._pallas_backward_sm`` in Pallas
  interpret mode and against ``jax.vjp`` of ``_fused_sm``, on the same
  numpy inputs and bool keep masks: several (S, N, d), N ragged against the
  TPU block, masked keys, zero context rows, dropout on and off.
  Tolerance: each gradient within 1e-5 * max(1, max|ref|). A zero context
  row makes dc of order 1e12 there (the derivative of the clamped cosine,
  ``c_j / 1e-12``), finite on both sides, so the bound scales with it.
- The plain backward against ``torch.autograd`` of the plain forward on
  inputs without a zero row, ``gradcheck`` of ``DualAttentionSm`` in f64,
  the repaired gradient hole (the op's gradients equal the plain route's,
  through its own autograd node) and the raw launchers' grad guard.
- The CUDA kernel itself is checked on the card
  (``test_k2_matches_plain_on_gpu`` and ``chip_smoke.py``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmgt_tpu.ops.dual_attention import _fused_sm, _pallas_backward_sm
from pmgt_tpu_torch.core import tracing
from pmgt_tpu_torch.models.pmgt import dual_attention_plain
from pmgt_tpu_torch.ops.dual_attention import (
    DualAttentionSm,
    dual_attention_sm,
    dual_attention_sm_backward,
    dual_attention_sm_backward_reference,
    dual_attention_sm_forward,
    dual_attention_sm_reference,
)

BIG_NEG = float(np.finfo(np.float32).min)
KEEP = 0.9


def _inputs(seed, s, n, d, zero_rows=True):
    rs = np.random.default_rng(seed)
    q, k, v, c, g = (rs.standard_normal((s, n, d)).astype(np.float32) for _ in range(5))
    if zero_rows:
        c[0, 0] = 0.0  # a zero context row: the cosine divides by max(., 1e-12)
        c[s - 1, n - 1] = 0.0
    mask = np.zeros((n, s), np.float32)
    if s > 1:
        mask[:, -1] = BIG_NEG  # last key masked everywhere
        mask[min(1, n - 1), 2:] = BIG_NEG  # a sequence with at most two keys
    m1 = rs.random((s, n, s)) < KEEP
    m2 = rs.random((s, n, s)) < KEEP
    return q, k, v, c, mask, m1, m2, g


def _t(xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def _assert_grads_close(got, want):
    for name, a, b in zip("qkvc", got, want, strict=True):
        a, b = np.asarray(a), np.asarray(b)
        assert np.isfinite(a).all(), name
        tol = 1e-5 * max(1.0, float(np.abs(b).max()))
        err = float(np.abs(a - b).max())
        assert err <= tol, (name, err, tol)


CASES = [
    (6, 300, 32, 0.5, False),  # N not a multiple of the 128 block
    (6, 300, 32, 0.5, True),
    (4, 17, 64, 0.3, True),
    (8, 37, 32, 0.7, False),
    (1, 5, 32, 0.6, True),  # a single position: only self-attention
]


@pytest.mark.parametrize("s,n,d,beta,use_dropout", CASES)
def test_backward_reference_matches_pallas_sm(s, n, d, beta, use_dropout):
    q, k, v, c, mask, m1, m2, g = _inputs(s * 1000 + n, s, n, d)
    want = _pallas_backward_sm(
        *(jnp.asarray(x) for x in (q, k, v, c, mask, m1, m2, g)),
        beta=beta, keep=KEEP, use_dropout=use_dropout,
    )
    got = dual_attention_sm_backward_reference(
        *_t((q, k, v, c, mask, m1, m2, g)), beta, KEEP, use_dropout
    )
    _assert_grads_close([x.numpy() for x in got], want)


@pytest.mark.parametrize("s,n,d,beta,use_dropout", CASES[1:3])
def test_backward_reference_matches_jax_vjp(s, n, d, beta, use_dropout):
    q, k, v, c, mask, m1, m2, g = _inputs(s * 7 + n, s, n, d)
    masks = tuple(jnp.asarray(x) for x in (mask, m1, m2))
    _, vjp = jax.vjp(
        lambda *a: _fused_sm(*a, *masks, beta, KEEP, use_dropout),
        *(jnp.asarray(x) for x in (q, k, v, c)),
    )
    want = vjp(jnp.asarray(g))
    got = dual_attention_sm_backward_reference(
        *_t((q, k, v, c, mask, m1, m2, g)), beta, KEEP, use_dropout
    )
    _assert_grads_close([x.numpy() for x in got], want)


@pytest.mark.parametrize("dtype,atol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("use_dropout", [False, True])
def test_backward_reference_matches_torch_autograd(dtype, atol, use_dropout):
    q, k, v, c, mask, m1, m2, g = _t(_inputs(5, 6, 23, 32, zero_rows=False))
    q, k, v, c, g = (x.to(dtype) for x in (q, k, v, c, g))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v, c)]
    out = dual_attention_sm_reference(*leaves, mask, m1, m2, 0.4, KEEP, use_dropout)
    want = torch.autograd.grad(out, leaves, g)
    got = dual_attention_sm_backward_reference(
        q, k, v, c, mask, m1, m2, g, 0.4, KEEP, use_dropout
    )
    for a, b in zip(got, want, strict=True):
        assert a.dtype == dtype
        torch.testing.assert_close(a, b, atol=atol, rtol=0)


@pytest.mark.parametrize("use_dropout", [False, True])
def test_gradcheck_f64(use_dropout):
    rs = np.random.default_rng(9)
    s, n, d = 3, 4, 5
    q, k, v, c = (torch.from_numpy(rs.standard_normal((s, n, d))).requires_grad_(True)
                  for _ in range(4))
    mask = torch.zeros(n, s, dtype=torch.float64)
    mask[1, 2] = BIG_NEG
    m1 = torch.from_numpy(rs.random((s, n, s)) < 0.7)
    m2 = torch.from_numpy(rs.random((s, n, s)) < 0.7)
    assert torch.autograd.gradcheck(
        lambda *a: DualAttentionSm.apply(*a, mask, m1, m2, 0.3, 0.7, use_dropout),
        (q, k, v, c),
    )


def test_op_gradients_equal_plain_route():
    """The gradient hole: the op must carry gradients through its own
    autograd node (whose backward is K2 on the card) and give the plain
    batch-major route's gradients."""
    q, k, v, c, mask, m1, m2, g = _t(_inputs(13, 6, 40, 32, zero_rows=False))
    leaves_a = [x.clone().requires_grad_(True) for x in (q, k, v, c)]
    out = dual_attention_sm(*leaves_a, mask, m1, m2, 0.5, KEEP, True)
    assert type(out.grad_fn).__name__ == "DualAttentionSmBackward"
    got = torch.autograd.grad(out, leaves_a, g)

    leaves_b = [x.clone().requires_grad_(True) for x in (q, k, v, c)]
    to_bm = lambda x: x.permute(1, 0, 2)[:, None]  # noqa: E731
    out_b = dual_attention_plain(
        *(to_bm(x) for x in leaves_b), mask[:, None, None, :], beta=0.5,
        keep_masks=(to_bm(m1), to_bm(m2)), keep=KEEP,
    )
    want = torch.autograd.grad(out_b[:, 0].permute(1, 0, 2), leaves_b, g)
    for a, b in zip(got, want, strict=True):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_raw_launchers_refuse_grad():
    q, k, v, c, mask, m1, m2, g = _t(_inputs(2, 4, 9, 32))
    qg = q.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no autograd node"):
        dual_attention_sm_forward(qg, k, v, c, mask)
    with pytest.raises(RuntimeError, match="no autograd node"):
        dual_attention_sm_backward(qg, k, v, c, mask, None, None, g)
    before = tracing.counters()
    with torch.no_grad():  # without grad the raw launchers run (plain on CPU)
        out = dual_attention_sm_forward(qg, k, v, c, mask)
        grads = dual_attention_sm_backward(qg, k, v, c, mask, None, None, g)
    torch.testing.assert_close(out, dual_attention_sm_reference(q, k, v, c, mask))
    assert len(grads) == 4
    # The counters count kernel launches only.
    assert tracing.counters() == before


# (N, S, d) on the card: the training shape and a ragged N, then edges of
# the tiling (one sequence, 32-lane key groups for S > 8, d not a multiple
# of 128, the largest S x d, where two stages do not fit in shared memory).
GPU_SHAPES = [(3072, 6, 128), (37, 6, 128), (1, 1, 32), (37, 9, 96),
              (3071, 32, 256), (3071, 8, 32), (37, 2, 256), (1, 32, 96)]


@pytest.mark.gpu
@pytest.mark.parametrize("n,s,d", GPU_SHAPES)
def test_k2_matches_plain_on_gpu(n, s, d):
    """K2 against the plain backward, without keep masks and with bool and
    f32 keep masks (needs a card and nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args = [x.cuda() for x in _t(_inputs(n, s, n, d))]
    q, k, v, c, mask, m1, m2, g = args
    for use_dropout, mdt in ((False, torch.bool), (True, torch.bool),
                             (True, torch.float32)):
        m1, m2 = m1.to(mdt), m2.to(mdt)
        got = dual_attention_sm_backward(q, k, v, c, mask, m1, m2, g, 0.5,
                                         KEEP, use_dropout)
        torch.cuda.synchronize()
        want = dual_attention_sm_backward_reference(
            q, k, v, c, mask, m1, m2, g, 0.5, KEEP, use_dropout)
        _assert_grads_close([x.cpu().numpy() for x in got],
                            [x.cpu().numpy() for x in want])
