"""Parity of the port's batch-major dual attention (K3 forward, K4
backward, behind the public op ``dual_attention_pallas``) with the JAX
package.

- ``dual_attention_bm_reference`` against ``_pallas_forward`` and the port's
  ``dual_attention_pallas`` (deterministic) against
  ``pmgt_tpu.ops.dual_attention_pallas``, both in Pallas interpret mode, on
  the same numpy inputs and explicit bool keep masks.
- ``dual_attention_bm_backward_reference`` against ``_pallas_backward`` and
  against ``jax.vjp`` of ``_fused``; the public op's autograd gradients
  against ``jax.vjp`` of the JAX op.
- Cases: f32, S in {1, 6}, h in {1, 2}, dropout on and off, masked keys, one
  zero context row. Tolerance: 1e-5 * max(1, max|ref|) per output; dc
  is checked apart on the sequences with and without the zero row, each
  with its own max|ref|.
- The dropout route draws m1 then m2 from the generator; it equals the
  explicit-mask route on masks drawn from the same seed. Without a
  generator it raises, as JAX does without ``dropout_rng``.
- The batch-major references equal the seq-major ones on permuted inputs.
- The CUDA kernels themselves are checked on the card
  (``test_k3_k4_match_plain_on_gpu`` and ``chip_smoke.py``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmgt_tpu.ops import dual_attention_pallas as jax_dual_attention_pallas
from pmgt_tpu.ops.dual_attention import _fused, _pallas_backward, _pallas_forward
from pmgt_tpu_torch.core import tracing
from pmgt_tpu_torch.ops import dual_attention_pallas
from pmgt_tpu_torch.ops.dual_attention import (
    DualAttentionBm,
    dual_attention_bm_backward,
    dual_attention_bm_backward_reference,
    dual_attention_bm_forward,
    dual_attention_bm_reference,
    dual_attention_sm_backward_reference,
    dual_attention_sm_reference,
)

BIG_NEG = float(np.finfo(np.float32).min)
KEEP = 0.9


def _inputs(seed, b, h, s, d):
    """q, k, v, c, g [B, h, S, d]; the additive mask [B, 1, 1, S]; keep
    masks m1, m2 [B·h, S, S] bool. One zero context row."""
    rs = np.random.default_rng(seed)
    q, k, v, c, g = (rs.standard_normal((b, h, s, d)).astype(np.float32)
                     for _ in range(5))
    c[0, h - 1, s - 1] = 0.0  # a zero context row
    mask = np.zeros((b, 1, 1, s), np.float32)
    if s > 1:
        mask[0, ..., -1] = BIG_NEG  # a masked key
        mask[b - 1, ..., 2:] = BIG_NEG  # a sequence with at most two keys
    m1 = rs.random((b * h, s, s)) < KEEP
    m2 = rs.random((b * h, s, s)) < KEEP
    return q, k, v, c, mask, m1, m2, g


def _fold(x):
    b, h, s, d = x.shape
    return x.reshape(b * h, s, d)


def _folded(q, k, v, c, mask, g, h):
    """The kernels' operands: [B·h, S, d] tensors and the [B·h, S] mask."""
    b, s = mask.shape[0], mask.shape[-1]
    mask_bs = np.broadcast_to(mask, (b, h, 1, s)).reshape(b * h, s)
    return [np.array(x) for x in
            (_fold(q), _fold(k), _fold(v), _fold(c), mask_bs, _fold(g))]


def _t(xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def _assert_close(got, want):
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (i, a.shape, b.shape)
        assert np.isfinite(a).all(), i
        tol = 1e-5 * max(1.0, float(np.abs(b).max()))
        err = float(np.abs(a - b).max())
        assert err <= tol, (i, err, tol)


def _assert_grads_close(got, want, c):
    """dq, dk, dv as ``_assert_close``. dc apart on the sequences that hold
    a zero context row (where it reaches ~1e12) and on the others, each
    with the limit taken from its own rows, so that the zero row's scale
    hides no error elsewhere."""
    _assert_close(got[:3], want[:3])
    s, d = c.shape[-2:]
    zero = (np.asarray(c).reshape(-1, s, d) == 0).all(-1).any(-1)
    assert zero.any() and not zero.all()
    dc_got, dc_want = (np.asarray(x).reshape(-1, s, d) for x in (got[3], want[3]))
    _assert_close([dc_got[zero], dc_got[~zero]], [dc_want[zero], dc_want[~zero]])


# (B, h, S, d, beta, dropout)
CASES = [
    (5, 1, 6, 32, 0.5, False),
    (5, 1, 6, 32, 0.5, True),
    (3, 2, 6, 32, 0.3, True),
    (7, 2, 6, 64, 0.7, False),
    (4, 2, 1, 32, 0.6, False),  # a single position: only self-attention
    (4, 1, 1, 32, 0.6, True),
]


@pytest.mark.parametrize("b,h,s,d,beta,use_dropout", CASES)
def test_forward_reference_matches_pallas(b, h, s, d, beta, use_dropout):
    q, k, v, c, mask, m1, m2, g = _inputs(b * 100 + s, b, h, s, d)
    fq, fk, fv, fc, mask_bs, _ = _folded(q, k, v, c, mask, g, h)
    want = _pallas_forward(
        *(jnp.asarray(x) for x in (fq, fk, fv, fc, mask_bs[:, None, :], m1, m2)),
        beta=beta, keep=KEEP, use_dropout=use_dropout,
    )
    got = dual_attention_bm_reference(
        *_t((fq, fk, fv, fc, mask_bs, m1, m2)), beta, KEEP, use_dropout
    )
    _assert_close([got.numpy()], [want])


@pytest.mark.parametrize("b,h,s,d,beta,use_dropout", CASES)
def test_backward_reference_matches_pallas(b, h, s, d, beta, use_dropout):
    q, k, v, c, mask, m1, m2, g = _inputs(b * 31 + s, b, h, s, d)
    fq, fk, fv, fc, mask_bs, fg = _folded(q, k, v, c, mask, g, h)
    want = _pallas_backward(
        *(jnp.asarray(x) for x in (fq, fk, fv, fc, mask_bs[:, None, :], m1, m2, fg)),
        beta=beta, keep=KEEP, use_dropout=use_dropout,
    )
    got = dual_attention_bm_backward_reference(
        *_t((fq, fk, fv, fc, mask_bs, m1, m2, fg)), beta, KEEP, use_dropout
    )
    _assert_grads_close([x.numpy() for x in got], want, fc)


@pytest.mark.parametrize("b,h,s,d,beta,use_dropout", CASES[1:4])
def test_backward_reference_matches_jax_vjp(b, h, s, d, beta, use_dropout):
    q, k, v, c, mask, m1, m2, g = _inputs(b * 7 + s, b, h, s, d)
    fq, fk, fv, fc, mask_bs, fg = _folded(q, k, v, c, mask, g, h)
    masks = tuple(jnp.asarray(x) for x in (mask_bs[:, None, :], m1, m2))
    _, vjp = jax.vjp(
        lambda *a: _fused(*a, *masks, beta, KEEP, use_dropout),
        *(jnp.asarray(x) for x in (fq, fk, fv, fc)),
    )
    want = vjp(jnp.asarray(fg))
    got = dual_attention_bm_backward_reference(
        *_t((fq, fk, fv, fc, mask_bs, m1, m2, fg)), beta, KEEP, use_dropout
    )
    _assert_grads_close([x.numpy() for x in got], want, fc)


@pytest.mark.parametrize("with_mask", [True, False])
@pytest.mark.parametrize("b,h,s,d", [(5, 1, 6, 32), (3, 2, 6, 64), (4, 2, 1, 32)])
def test_public_op_matches_jax_op(b, h, s, d, with_mask):
    """Deterministic: output and the gradients of all four inputs."""
    q, k, v, c, mask, _, _, g = _inputs(b + s + h, b, h, s, d)
    jmask = jnp.asarray(mask) if with_mask else None
    want, vjp = jax.vjp(
        lambda *a: jax_dual_attention_pallas(*a, jmask, 0.4, 0.1, True, None),
        *(jnp.asarray(x) for x in (q, k, v, c)),
    )
    want_grads = vjp(jnp.asarray(g))

    leaves = [x.requires_grad_(True) for x in _t((q, k, v, c))]
    tmask = torch.from_numpy(mask) if with_mask else None
    out = dual_attention_pallas(*leaves, tmask, 0.4, 0.1, True, None)
    assert out.shape == (b, h, s, d)
    assert out.grad_fn.next_functions[0][0].name() == "DualAttentionBmBackward"
    got_grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    _assert_close([out.detach().numpy()], [want])
    _assert_grads_close([x.numpy() for x in got_grads], want_grads, c)


def test_dropout_route_equals_explicit_masks():
    b, h, s, d = 4, 2, 6, 32
    q, k, v, c, mask, _, _, g = _t(_inputs(11, b, h, s, d))
    out = dual_attention_pallas(q, k, v, c, mask, 0.5, 0.2, False,
                                torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    m1 = torch.rand((b * h, s, s), generator=gen) < 0.8
    m2 = torch.rand((b * h, s, s), generator=gen) < 0.8
    fq, fk, fv, fc, mask_bs, _ = _t(_folded(*(x.numpy() for x in (q, k, v, c, mask, g)), h))
    want = DualAttentionBm.apply(fq, fk, fv, fc, mask_bs, m1, m2, 0.5, 0.8, True)
    torch.testing.assert_close(out, want.reshape(b, h, s, d), rtol=0, atol=0)
    assert not m1.all() and not m2.all() and not torch.equal(m1, m2)
    det = dual_attention_pallas(q, k, v, c, mask, 0.5, 0.2, True, None)
    assert not torch.equal(out, det)  # the masks took effect
    with pytest.raises(ValueError, match="generator is required"):
        dual_attention_pallas(q, k, v, c, mask, 0.5, 0.2, False, None)


def test_batch_major_references_equal_seq_major_on_permuted_inputs():
    b, h, s, d = 6, 1, 6, 32
    q, k, v, c, mask, m1, m2, g = _inputs(3, b, h, s, d)
    fq, fk, fv, fc, mask_bs, fg = _t(_folded(q, k, v, c, mask, g, h))
    m1, m2 = _t((m1, m2))
    sm = lambda x: x.transpose(0, 1).contiguous()  # noqa: E731
    out = dual_attention_bm_reference(fq, fk, fv, fc, mask_bs, m1, m2, 0.5, KEEP, True)
    out_sm = dual_attention_sm_reference(
        *map(sm, (fq, fk, fv, fc)), mask_bs, sm(m1), sm(m2), 0.5, KEEP, True)
    torch.testing.assert_close(out, sm(out_sm), rtol=0, atol=1e-6)
    grads = dual_attention_bm_backward_reference(
        fq, fk, fv, fc, mask_bs, m1, m2, fg, 0.5, KEEP, True)
    grads_sm = dual_attention_sm_backward_reference(
        *map(sm, (fq, fk, fv, fc)), mask_bs, sm(m1), sm(m2), sm(fg), 0.5, KEEP, True)
    _assert_grads_close([x.numpy() for x in grads], [sm(x).numpy() for x in grads_sm], fc)


def test_raw_bm_launchers_refuse_grad_and_count_only_kernels():
    q, k, v, c, mask, m1, m2, g = _inputs(2, 3, 1, 6, 32)
    fq, fk, fv, fc, mask_bs, fg = _t(_folded(q, k, v, c, mask, g, 1))
    qg = fq.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no autograd node"):
        dual_attention_bm_forward(qg, fk, fv, fc, mask_bs)
    with pytest.raises(RuntimeError, match="no autograd node"):
        dual_attention_bm_backward(qg, fk, fv, fc, mask_bs, None, None, fg)
    before = tracing.counters()
    with torch.no_grad():
        dual_attention_bm_forward(fq, fk, fv, fc, mask_bs)
        dual_attention_bm_backward(fq, fk, fv, fc, mask_bs, None, None, fg)
    assert tracing.counters() == before


# (B, h, S, d) on the card: B·h = 3072 and a ragged 37 at h = 1, d = 128,
# and h = 2, d = 64; then edges of the tiling (one sequence, 32-lane key
# groups for S > 8, d not a multiple of 128, the largest S x d, where two
# stages do not fit in shared memory).
GPU_SHAPES = [(3072, 1, 6, 128), (37, 1, 6, 128), (300, 2, 6, 64),
              (1, 1, 1, 32), (37, 1, 9, 96), (3071, 1, 32, 256),
              (3071, 1, 8, 32), (37, 1, 2, 256), (1, 1, 32, 96)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,s,d", GPU_SHAPES)
def test_k3_k4_match_plain_on_gpu(b, h, s, d):
    """K3 and K4 against the plain batch-major versions, without keep
    masks and with bool and f32 keep masks; and K3/K4 against K1/K2 on the
    same tensors permuted (needs a card and nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from pmgt_tpu_torch.ops.dual_attention import (
        dual_attention_sm_backward,
        dual_attention_sm_forward,
    )

    q, k, v, c, mask, m1, m2, g = _inputs(b, b, h, s, d)
    fq, fk, fv, fc, mask_bs, fg = (x.cuda() for x in _t(_folded(q, k, v, c, mask, g, h)))
    m1, m2 = torch.from_numpy(m1).cuda(), torch.from_numpy(m2).cuda()
    for use_dropout, mdt in ((False, torch.bool), (True, torch.bool),
                             (True, torch.float32)):
        args = (fq, fk, fv, fc, mask_bs, m1.to(mdt), m2.to(mdt))
        out = dual_attention_bm_forward(*args, 0.5, KEEP, use_dropout)
        grads = dual_attention_bm_backward(*args, fg, 0.5, KEEP, use_dropout)
        torch.cuda.synchronize()
        _assert_close([out.cpu()], [dual_attention_bm_reference(
            *args, 0.5, KEEP, use_dropout).cpu()])
        want = [x.cpu() for x in dual_attention_bm_backward_reference(
            *args, fg, 0.5, KEEP, use_dropout)]
        if b * h > 1:
            _assert_grads_close([x.cpu() for x in grads], want, fc.cpu())
        else:  # the one sequence holds the zero context row
            _assert_close([x.cpu() for x in grads], want)
        sm = lambda x: x.transpose(0, 1).contiguous()  # noqa: E731
        sm_args = (*map(sm, (fq, fk, fv, fc)), mask_bs, sm(m1), sm(m2))
        out_sm = dual_attention_sm_forward(*sm_args, 0.5, KEEP, use_dropout)
        torch.testing.assert_close(out, sm(out_sm), rtol=0, atol=1e-6)
        grads_sm = dual_attention_sm_backward(*sm_args, sm(fg), 0.5, KEEP, use_dropout)
        for a, b_ in zip(grads, grads_sm):
            torch.testing.assert_close(a, sm(b_), rtol=1e-6, atol=1e-6)
