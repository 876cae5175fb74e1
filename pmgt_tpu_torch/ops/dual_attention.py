"""PMGT dual attention in the seq-major layout, forward and backward
(counterparts of the TPU kernels ``_pallas_forward_sm`` and
``_pallas_backward_sm`` in ``pmgt_tpu/ops/dual_attention.py``).

For each sequence n of q, k, v, c [S, N, d] (N = batch x heads), with the
additive key mask ``mask_bs`` [N, S]:

    P1  = softmax(1 - cos(c, c) + I + M)
    P2  = softmax(q kᵀ / √d + M)
    out = (β · P1 · m1/keep + (1 - β) · P2 · m2/keep) · v      [S, N, d]

where the keep masks m1, m2 [S, N, S] apply only with ``use_dropout``.
Math is f32 whatever the operand type (f64 operands, which only the CPU
takes, stay f64); outputs have q's type.

- ``dual_attention_sm_reference`` / ``dual_attention_sm_backward_reference``:
  the plain PyTorch versions (the math of ``_fwd_math`` and ``_bwd_math``).
  The backward recomputes P1 and P2 from the inputs and is a transcription
  of ``_bwd_math``, not autograd of the forward: at a zero context row
  autograd through the norm gives NaN where ``_bwd_math`` stays finite.
- ``dual_attention_sm_forward`` / ``dual_attention_sm_backward``: the raw
  launchers. CPU tensors take the plain versions; CUDA tensors launch the
  hand-written kernels (``csrc/dual_attention_fwd.cu``, K1, and
  ``csrc/dual_attention_bwd.cu``, K2) or raise. They build no autograd
  node, so they refuse inputs that require grad while grad is enabled.
  ``dual_attention_sm.launches`` counts K1 launches and
  ``dual_attention_sm_backward.launches`` K2 launches.
- ``DualAttentionSm`` / ``dual_attention_sm``: the differentiable op. Its
  forward is K1 (or the plain forward), its backward K2 (or the plain
  backward); it saves (q, k, v, c, mask, m1, m2), as ``_fused_sm_fwd``
  does. No gradient flows to the mask or the keep masks.
- ``draw_keep_masks``: the two [S, N, S] bool keep masks, drawn outside
  the kernels so the forward, the backward and the plain batch-major route
  all see one dropout pattern.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from pmgt_tpu_torch.ops import build

MAX_SEQ = 32
MAX_HEAD_DIM = 256


def _math_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _probs(qf, kf, cf, add, d):
    """Batch-major recompute shared by the plain forward and backward:
    (norm², clamped norm outer product, cos, P1, P2), each [N, S, ·]."""
    s = qf.shape[1]
    norm_sq = torch.sum(cf * cf, dim=-1, keepdim=True)  # [N, S, 1]
    norm = torch.sqrt(norm_sq)
    n_outer = torch.clamp(norm @ norm.transpose(1, 2), min=1e-12)
    cos = (cf @ cf.transpose(1, 2)) / n_outer
    eye = torch.eye(s, dtype=qf.dtype, device=qf.device)
    s1 = 1.0 - cos + eye + add
    s1 = s1 - torch.amax(s1, dim=-1, keepdim=True)
    e1 = torch.exp(s1)
    p1 = e1 / torch.sum(e1, dim=-1, keepdim=True)

    s2 = (qf @ kf.transpose(1, 2)) * (1.0 / (d**0.5)) + add
    s2 = s2 - torch.amax(s2, dim=-1, keepdim=True)
    e2 = torch.exp(s2)
    p2 = e2 / torch.sum(e2, dim=-1, keepdim=True)
    return norm_sq, n_outer, cos, p1, p2


def dual_attention_sm_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    c: torch.Tensor,
    mask_bs: torch.Tensor,
    m1: Optional[torch.Tensor] = None,
    m2: Optional[torch.Tensor] = None,
    beta: float = 0.5,
    keep: float = 1.0,
    use_dropout: bool = False,
) -> torch.Tensor:
    """Plain PyTorch dual attention in the seq-major layout."""
    f = _math_dtype(q)
    d = q.shape[-1]
    qf, kf, vf, cf = (x.to(f).transpose(0, 1) for x in (q, k, v, c))
    add = mask_bs.to(f)[:, None, :]  # [N, 1, S]
    _, _, _, p1, p2 = _probs(qf, kf, cf, add, d)
    if use_dropout:
        inv_keep = 1.0 / keep
        p1 = p1 * m1.to(f).transpose(0, 1) * inv_keep
        p2 = p2 * m2.to(f).transpose(0, 1) * inv_keep

    probs = beta * p1 + (1.0 - beta) * p2  # [N, S, S]
    out = probs @ vf  # [N, S, d]
    return out.transpose(0, 1).contiguous().to(q.dtype)


def dual_attention_sm_backward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    c: torch.Tensor,
    mask_bs: torch.Tensor,
    m1: Optional[torch.Tensor],
    m2: Optional[torch.Tensor],
    g: torch.Tensor,
    beta: float = 0.5,
    keep: float = 1.0,
    use_dropout: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward in the seq-major layout: (dq, dk, dv, dc), each
    [S, N, d], for the output gradient ``g`` [S, N, d]. A transcription of
    the JAX package's ``_bwd_math``."""
    f = _math_dtype(q)
    d = q.shape[-1]
    qf, kf, vf, cf, gf = (x.to(f).transpose(0, 1) for x in (q, k, v, c, g))
    add = mask_bs.to(f)[:, None, :]
    norm_sq, n_outer, cos, p1, p2 = _probs(qf, kf, cf, add, d)
    inv_sqrt_d = 1.0 / (d**0.5)
    if use_dropout:
        inv_keep = 1.0 / keep
        m1f = m1.to(f).transpose(0, 1) * inv_keep
        m2f = m2.to(f).transpose(0, 1) * inv_keep
        probs = beta * (p1 * m1f) + (1.0 - beta) * (p2 * m2f)
    else:
        probs = beta * p1 + (1.0 - beta) * p2

    dv = probs.transpose(1, 2) @ gf
    dprobs = gf @ vf.transpose(1, 2)
    dp1 = beta * dprobs
    dp2 = (1.0 - beta) * dprobs
    if use_dropout:
        dp1 = dp1 * m1f
        dp2 = dp2 * m2f
    # softmax backward per distribution
    ds1 = p1 * (dp1 - torch.sum(dp1 * p1, dim=-1, keepdim=True))
    ds2 = p2 * (dp2 - torch.sum(dp2 * p2, dim=-1, keepdim=True))

    dq = (ds2 @ kf) * inv_sqrt_d
    dk = (ds2.transpose(1, 2) @ qf) * inv_sqrt_d
    # cosine branch: s1 = 1 - cos + ... → dcos = -ds1
    gsym = -(ds1 + ds1.transpose(1, 2))
    srow = torch.sum(gsym * cos, dim=-1, keepdim=True) / torch.clamp(
        norm_sq, min=1e-12
    )
    dc = (gsym / n_outer) @ cf - srow * cf
    return tuple(
        x.transpose(0, 1).contiguous().to(q.dtype) for x in (dq, dk, dv, dc)
    )


def draw_keep_masks(
    s: int, n: int, keep: float, generator: torch.Generator
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The attention keep masks m1, m2: [S, N, S] bool, True with
    probability ``keep`` (``uniform < keep``, as ``jax.random.bernoulli``),
    drawn m1 first on the generator's device."""
    dev = generator.device
    m1 = torch.rand((s, n, s), generator=generator, device=dev) < keep
    m2 = torch.rand((s, n, s), generator=generator, device=dev) < keep
    return m1, m2


# ----------------------------------------------------------------------
# raw launchers
# ----------------------------------------------------------------------

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _refuse_grad(*xs: torch.Tensor) -> None:
    """The raw launchers build no autograd node: a gradient through them
    would silently be zero, so they refuse where one is wanted."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        raise RuntimeError(
            "the raw dual-attention launchers have no autograd node; call "
            "dual_attention_sm, whose backward is the K2 kernel"
        )


def _keep_mask_kind(m1, m2) -> int:
    if m1.dtype != m2.dtype:
        raise ValueError(f"m1/m2 dtypes differ: {m1.dtype} vs {m2.dtype}")
    if m1.dtype in (torch.bool, torch.uint8):
        return 1
    if m1.dtype == torch.float32:
        return 2
    raise ValueError(f"keep masks must be bool, uint8 or float32, got {m1.dtype}")


def _kernel_operands(q, others, mask_bs, m1, m2, use_dropout):
    """Check the CUDA operands against the kernels' limits; returns the
    contiguous (q, *others), the f32 mask, the keep masks as u8 or f32 (or
    None) and the mask kind (0 none, 1 u8, 2 f32)."""
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    s, n, d = q.shape
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"operands must be float32 or bfloat16, got {q.dtype}")
    if not 1 <= s <= MAX_SEQ or d % 32 or not 32 <= d <= MAX_HEAD_DIM:
        raise ValueError(
            f"kernel limits: 1 <= S <= {MAX_SEQ}, d a multiple of 32 in "
            f"[32, {MAX_HEAD_DIM}]; got S={s}, d={d}"
        )
    for x in others:
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError("k, v, c (and g) must match q in shape, dtype and device")
    if tuple(mask_bs.shape) != (n, s) or mask_bs.device != q.device:
        raise ValueError(f"mask_bs must be [{n}, {s}] on {q.device}")
    mask_kind = 0
    if use_dropout:
        if m1 is None or m2 is None:
            raise ValueError("use_dropout needs both keep masks m1 and m2")
        for m in (m1, m2):
            if tuple(m.shape) != (s, n, s) or m.device != q.device:
                raise ValueError(f"keep masks must be [{s}, {n}, {s}] on {q.device}")
        mask_kind = _keep_mask_kind(m1, m2)
        m1, m2 = (
            m.contiguous().view(torch.uint8) if m.dtype == torch.bool
            else m.contiguous()
            for m in (m1, m2)
        )
    else:
        m1 = m2 = None
    xs = tuple(x.contiguous() for x in (q, *others))
    for x in xs:
        if x.data_ptr() % 16:
            raise ValueError("operands must be 16-byte aligned")
    return xs, mask_bs.to(torch.float32).contiguous(), m1, m2, mask_kind


def _ptr(m):
    return None if m is None else m.data_ptr()


def _fwd_fn():
    fn = build.load("dual_attention_fwd").pmgt_dual_attention_fwd_sm
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p, p, i, p, i, i, i, i, f, f, f, f, p]
        fn.restype = i
    return fn


def _bwd_fn():
    fn = build.load("dual_attention_bwd").pmgt_dual_attention_bwd
    if fn.argtypes is None:
        p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        fn.argtypes = ([p] * 7 + [i] + [p] * 5 + [i] * 4 + [ll] * 4
                       + [f] * 4 + [p])
        fn.restype = i
    return fn


def dual_attention_sm_forward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    c: torch.Tensor,
    mask_bs: torch.Tensor,
    m1: Optional[torch.Tensor] = None,
    m2: Optional[torch.Tensor] = None,
    beta: float = 0.5,
    keep: float = 1.0,
    use_dropout: bool = False,
) -> torch.Tensor:
    """Raw forward (no autograd node): q/k/v/c [S, N, d], mask_bs [N, S] →
    [S, N, d]. CPU tensors run the plain version; CUDA tensors launch K1
    (f32 or bf16 operands, S <= 32, d a multiple of 32 up to 256) or
    raise."""
    _refuse_grad(q, k, v, c)
    if q.device.type == "cpu":
        return dual_attention_sm_reference(
            q, k, v, c, mask_bs, m1, m2, beta, keep, use_dropout
        )
    (q, k, v, c), mask, m1, m2, mask_kind = _kernel_operands(
        q, (k, v, c), mask_bs, m1, m2, use_dropout
    )
    s, n, d = q.shape
    out = torch.empty_like(q)
    fn = _fwd_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), c.data_ptr(),
            mask.data_ptr(), _ptr(m1), _ptr(m2), mask_kind, out.data_ptr(),
            s, n, d, _KERNEL_DTYPES[q.dtype],
            float(beta), float(1.0 - beta),
            float(1.0 / keep) if mask_kind else 1.0,
            float(1.0 / (d**0.5)), stream,
        )
    if rc != 0:
        raise RuntimeError(f"dual_attention_fwd launch failed: CUDA error {rc}")
    dual_attention_sm.launches += 1
    return out


def dual_attention_sm_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    c: torch.Tensor,
    mask_bs: torch.Tensor,
    m1: Optional[torch.Tensor],
    m2: Optional[torch.Tensor],
    g: torch.Tensor,
    beta: float = 0.5,
    keep: float = 1.0,
    use_dropout: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Raw backward (no autograd node): (dq, dk, dv, dc) [S, N, d] for the
    output gradient ``g``. CPU tensors run the plain version; CUDA tensors
    launch K2 or raise."""
    _refuse_grad(q, k, v, c, g)
    if q.device.type == "cpu":
        return dual_attention_sm_backward_reference(
            q, k, v, c, mask_bs, m1, m2, g, beta, keep, use_dropout
        )
    (q, k, v, c, g), mask, m1, m2, mask_kind = _kernel_operands(
        q, (k, v, c, g), mask_bs, m1, m2, use_dropout
    )
    s, n, d = q.shape
    grads = tuple(torch.empty_like(q) for _ in range(4))
    fn = _bwd_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), c.data_ptr(),
            mask.data_ptr(), _ptr(m1), _ptr(m2), mask_kind, g.data_ptr(),
            *(x.data_ptr() for x in grads),
            s, n, d, _KERNEL_DTYPES[q.dtype],
            n * d, d, n * s, s,  # seq-major strides: [S, N, d], [S, N, S]
            float(beta), float(1.0 - beta),
            float(1.0 / keep) if mask_kind else 1.0,
            float(1.0 / (d**0.5)), stream,
        )
    if rc != 0:
        raise RuntimeError(f"dual_attention_bwd launch failed: CUDA error {rc}")
    dual_attention_sm_backward.launches += 1
    return grads


dual_attention_sm_backward.launches = 0


# ----------------------------------------------------------------------
# the differentiable op
# ----------------------------------------------------------------------

class DualAttentionSm(torch.autograd.Function):
    """Seq-major dual attention with K1 as forward and K2 as backward (or
    their plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, c, mask_bs, m1, m2, beta, keep, use_dropout):
        out = dual_attention_sm_forward(
            q, k, v, c, mask_bs, m1, m2, beta, keep, use_dropout
        )
        ctx.save_for_backward(q, k, v, c, mask_bs, m1, m2)
        ctx.hyper = (beta, keep, use_dropout)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, c, mask_bs, m1, m2 = ctx.saved_tensors
        dq, dk, dv, dc = dual_attention_sm_backward(
            q, k, v, c, mask_bs, m1, m2, g.contiguous(), *ctx.hyper
        )
        return dq, dk, dv, dc, None, None, None, None, None, None


def dual_attention_sm(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    c: torch.Tensor,
    mask_bs: torch.Tensor,
    m1: Optional[torch.Tensor] = None,
    m2: Optional[torch.Tensor] = None,
    beta: float = 0.5,
    keep: float = 1.0,
    use_dropout: bool = False,
) -> torch.Tensor:
    """Differentiable seq-major dual attention: q/k/v/c [S, N, d],
    mask_bs [N, S] → [S, N, d]. CPU tensors run the plain forward and
    backward; CUDA tensors launch K1 and K2 or raise."""
    return DualAttentionSm.apply(
        q, k, v, c, mask_bs, m1, m2, float(beta), float(keep), bool(use_dropout)
    )


dual_attention_sm.launches = 0
