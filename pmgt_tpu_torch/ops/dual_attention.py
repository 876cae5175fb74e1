"""PMGT dual attention, forward and backward, in the seq-major layout
(counterparts of the TPU kernels ``_pallas_forward_sm`` and
``_pallas_backward_sm`` in ``pmgt_tpu/ops/dual_attention.py``) and in the
batch-major layout (``_pallas_forward`` and ``_pallas_backward``, behind
the public op ``dual_attention_pallas``).

For each sequence n of q, k, v, c (N = batch x heads), with the additive
key mask ``mask_bs`` [N, S]:

    P1  = softmax(1 - cos(c, c) + I + M)
    P2  = softmax(q kᵀ / √d + M)
    out = (β · P1 · m1/keep + (1 - β) · P2 · m2/keep) · v

where the keep masks m1, m2 apply only with ``use_dropout``. Seq-major
operands are [S, N, d] with keep masks [S, N, S]; batch-major operands are
[N, S, d] with keep masks [N, S, S]. Math is f32 whatever the operand type
(f64 operands, which only the CPU takes, stay f64); outputs have q's type.

- ``dual_attention_bm_reference`` / ``dual_attention_bm_backward_reference``:
  the plain PyTorch versions (the math of ``_fwd_math`` and ``_bwd_math``);
  the ``_sm_`` references are the same on transposed views. The backward
  recomputes P1 and P2 from the inputs and is a transcription of
  ``_bwd_math``, not autograd of the forward: at a zero context row
  autograd through the norm gives NaN where ``_bwd_math`` stays finite.
- ``dual_attention_{sm,bm}_forward`` / ``dual_attention_{sm,bm}_backward``:
  the raw launchers. CPU tensors take the plain versions; CUDA tensors
  launch the hand-written kernels or raise: ``csrc/dual_attention_fwd.cu``
  (K1 seq-major, K3 batch-major: one kernel, two stride sets) and
  ``csrc/dual_attention_bwd.cu`` (K2 and K4, likewise). They build no
  autograd node, so they refuse inputs that require grad while grad is
  enabled. Each card launch adds one to its counter of
  ``core/tracing.py``: ``k1_launches`` (K1), ``k2_launches`` (K2),
  ``k3_launches`` (K3) and ``k4_launches`` (K4); ``launch_counts()`` reads
  the four.
- ``DualAttentionSm`` / ``dual_attention_sm`` and ``DualAttentionBm``: the
  differentiable ops. They save (q, k, v, c, mask, m1, m2), as
  ``_fused_sm_fwd`` / ``_fused_fwd`` do. No gradient flows to the mask or
  the keep masks.
- ``dual_attention_pallas``: the public batch-major op over [B, h, S, d]
  inputs, the counterpart of ``pmgt_tpu.ops.dual_attention_pallas``, with
  an explicit ``torch.Generator`` in place of ``dropout_rng``.
- ``draw_keep_masks``: the two [S, N, S] bool keep masks, drawn outside
  the kernels so the forward, the backward and the plain batch-major route
  all see one dropout pattern.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from pmgt_tpu_torch.core import tracing
from pmgt_tpu_torch.core.mesh import rand
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


def dual_attention_bm_reference(
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
    """Plain PyTorch dual attention in the batch-major layout: q/k/v/c
    [N, S, d], mask_bs [N, S], m1/m2 [N, S, S] → [N, S, d]."""
    f = _math_dtype(q)
    d = q.shape[-1]
    qf, kf, vf, cf = (x.to(f) for x in (q, k, v, c))
    add = mask_bs.to(f)[:, None, :]  # [N, 1, S]
    _, _, _, p1, p2 = _probs(qf, kf, cf, add, d)
    if use_dropout:
        inv_keep = 1.0 / keep
        p1 = p1 * m1.to(f) * inv_keep
        p2 = p2 * m2.to(f) * inv_keep

    probs = beta * p1 + (1.0 - beta) * p2  # [N, S, S]
    return (probs @ vf).to(q.dtype)


def dual_attention_bm_backward_reference(
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
    """Plain backward in the batch-major layout: (dq, dk, dv, dc), each
    [N, S, d], for the output gradient ``g`` [N, S, d]. A transcription of
    the JAX package's ``_bwd_math``."""
    f = _math_dtype(q)
    d = q.shape[-1]
    qf, kf, vf, cf, gf = (x.to(f) for x in (q, k, v, c, g))
    add = mask_bs.to(f)[:, None, :]
    norm_sq, n_outer, cos, p1, p2 = _probs(qf, kf, cf, add, d)
    inv_sqrt_d = 1.0 / (d**0.5)
    if use_dropout:
        inv_keep = 1.0 / keep
        m1f = m1.to(f) * inv_keep
        m2f = m2.to(f) * inv_keep
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
    return tuple(x.to(q.dtype) for x in (dq, dk, dv, dc))


def _swap01(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """[S, N, ·] ↔ [N, S, ·] (a view; None stays None)."""
    return None if x is None else x.transpose(0, 1)


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
    """Plain PyTorch dual attention in the seq-major layout: q/k/v/c
    [S, N, d], m1/m2 [S, N, S] → [S, N, d]."""
    q, k, v, c, m1, m2 = map(_swap01, (q, k, v, c, m1, m2))
    out = dual_attention_bm_reference(
        q, k, v, c, mask_bs, m1, m2, beta, keep, use_dropout
    )
    return out.transpose(0, 1).contiguous()


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
    [S, N, d], for the output gradient ``g`` [S, N, d]."""
    q, k, v, c, m1, m2, g = map(_swap01, (q, k, v, c, m1, m2, g))
    grads = dual_attention_bm_backward_reference(
        q, k, v, c, mask_bs, m1, m2, g, beta, keep, use_dropout
    )
    return tuple(x.transpose(0, 1).contiguous() for x in grads)


def draw_keep_masks(
    s: int, n: int, keep: float, generator, group: int = 1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The attention keep masks m1, m2: [S, N, S] bool, True with
    probability ``keep`` (``uniform < keep``, as ``jax.random.bernoulli``),
    drawn m1 first on the generator's device. From a data-parallel rank's
    ``core.mesh.ShardedDraws`` the rank's lanes of the global masks, each
    lane ``group`` (the heads) consecutive columns of axis 1."""
    m1 = rand((s, n, s), generator, axis=1, group=group) < keep
    m2 = rand((s, n, s), generator, axis=1, group=group) < keep
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
            "dual_attention_sm or dual_attention_pallas, whose backward is "
            "a kernel"
        )


def _keep_mask_kind(m1, m2) -> int:
    if m1.dtype != m2.dtype:
        raise ValueError(f"m1/m2 dtypes differ: {m1.dtype} vs {m2.dtype}")
    if m1.dtype in (torch.bool, torch.uint8):
        return 1
    if m1.dtype == torch.float32:
        return 2
    raise ValueError(f"keep masks must be bool, uint8 or float32, got {m1.dtype}")


def _kernel_operands(q, others, mask_bs, m1, m2, use_dropout, batch_major):
    """Check the CUDA operands against the kernels' limits. Returns the
    contiguous (q, *others), the f32 mask, the keep masks as u8 or f32 (or
    None), the mask kind (0 none, 1 u8, 2 f32), (S, N, d) and the element
    strides (pos, seq, mask pos, mask seq) of the layout."""
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if batch_major:
        n, s, d = q.shape
        keep_shape, strides = (n, s, s), (d, s * d, s, s * s)
    else:
        s, n, d = q.shape
        keep_shape, strides = (s, n, s), (n * d, d, n * s, s)
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
            if tuple(m.shape) != keep_shape or m.device != q.device:
                raise ValueError(f"keep masks must be {list(keep_shape)} on {q.device}")
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
    mask = mask_bs.to(torch.float32).contiguous()
    return xs, mask, m1, m2, mask_kind, (s, n, d), strides


def _ptr(m):
    return None if m is None else m.data_ptr()


# The C entry points of the kernel libraries: name -> (library, pointers
# after mask_kind: the output for the forward; g and the four gradients for
# the backward).
C_ENTRIES = {
    "pmgt_dual_attention_fwd": ("dual_attention_fwd", 1),
    "pmgt_dual_attention_bwd": ("dual_attention_bwd", 5),
}


def entry_argtypes(n_out: int) -> list:
    """ctypes types of a strided C entry: q, k, v, c, mask, m1, m2,
    mask_kind, ``n_out`` pointers, S, N, d, dtype, four strides, beta,
    1 - beta, 1 / keep, 1 / √d, stream. A pointer typed as an int would be
    cut to 32 bits without a word, so a CPU test holds this list against
    the C declarations."""
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    return [p] * 7 + [i] + [p] * n_out + [i] * 4 + [ll] * 4 + [f] * 4 + [p]


def _entry(name: str):
    """The typed C entry ``name`` (see ``C_ENTRIES``), built at first use."""
    lib, n_out = C_ENTRIES[name]
    fn = getattr(build.load(lib), name)
    if fn.argtypes is None:
        fn.argtypes = entry_argtypes(n_out)
        fn.restype = ctypes.c_int
    return fn


def _scalars(beta, keep, mask_kind, d, device):
    stream = torch.cuda.current_stream(device).cuda_stream
    return (float(beta), float(1.0 - beta),
            float(1.0 / keep) if mask_kind else 1.0, float(1.0 / (d**0.5)),
            stream)


def _launch_forward(q, k, v, c, mask_bs, m1, m2, beta, keep, use_dropout,
                    batch_major):
    """K1 (seq-major strides) or K3 (batch-major strides): one kernel, one
    strided C entry. Returns the output."""
    (q, k, v, c), mask, m1, m2, mask_kind, (s, n, d), strides = _kernel_operands(
        q, (k, v, c), mask_bs, m1, m2, use_dropout, batch_major
    )
    out = torch.empty_like(q)
    fn = _entry("pmgt_dual_attention_fwd")
    with torch.cuda.device(q.device):
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), c.data_ptr(),
            mask.data_ptr(), _ptr(m1), _ptr(m2), mask_kind, out.data_ptr(),
            s, n, d, _KERNEL_DTYPES[q.dtype],
            *strides, *_scalars(beta, keep, mask_kind, d, q.device),
        )
    if rc != 0:
        raise RuntimeError(f"dual_attention_fwd launch failed: CUDA error {rc}")
    return out


def _launch_backward(q, k, v, c, mask_bs, m1, m2, g, beta, keep, use_dropout,
                     batch_major):
    """K2 (seq-major strides) or K4 (batch-major strides): one kernel, one
    strided C entry. Returns (dq, dk, dv, dc)."""
    (q, k, v, c, g), mask, m1, m2, mask_kind, (s, n, d), strides = _kernel_operands(
        q, (k, v, c, g), mask_bs, m1, m2, use_dropout, batch_major
    )
    grads = tuple(torch.empty_like(q) for _ in range(4))
    fn = _entry("pmgt_dual_attention_bwd")
    with torch.cuda.device(q.device):
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), c.data_ptr(),
            mask.data_ptr(), _ptr(m1), _ptr(m2), mask_kind, g.data_ptr(),
            *(x.data_ptr() for x in grads), s, n, d, _KERNEL_DTYPES[q.dtype],
            *strides, *_scalars(beta, keep, mask_kind, d, q.device),
        )
    if rc != 0:
        raise RuntimeError(f"dual_attention_bwd launch failed: CUDA error {rc}")
    return grads


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
    out = _launch_forward(q, k, v, c, mask_bs, m1, m2, beta, keep,
                          use_dropout, batch_major=False)
    tracing.count("k1_launches")
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
    grads = _launch_backward(q, k, v, c, mask_bs, m1, m2, g, beta, keep,
                             use_dropout, batch_major=False)
    tracing.count("k2_launches")
    return grads


def dual_attention_bm_forward(
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
    """Raw batch-major forward (no autograd node): q/k/v/c [N, S, d],
    mask_bs [N, S], m1/m2 [N, S, S] → [N, S, d]. CPU tensors run the plain
    version; CUDA tensors launch K3 or raise."""
    _refuse_grad(q, k, v, c)
    if q.device.type == "cpu":
        return dual_attention_bm_reference(
            q, k, v, c, mask_bs, m1, m2, beta, keep, use_dropout
        )
    out = _launch_forward(q, k, v, c, mask_bs, m1, m2, beta, keep,
                          use_dropout, batch_major=True)
    tracing.count("k3_launches")
    return out


def dual_attention_bm_backward(
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
    """Raw batch-major backward (no autograd node): (dq, dk, dv, dc)
    [N, S, d] for the output gradient ``g``. CPU tensors run the plain
    version; CUDA tensors launch K4 or raise."""
    _refuse_grad(q, k, v, c, g)
    if q.device.type == "cpu":
        return dual_attention_bm_backward_reference(
            q, k, v, c, mask_bs, m1, m2, g, beta, keep, use_dropout
        )
    grads = _launch_backward(q, k, v, c, mask_bs, m1, m2, g, beta, keep,
                             use_dropout, batch_major=True)
    tracing.count("k4_launches")
    return grads


# ----------------------------------------------------------------------
# the differentiable ops
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


class DualAttentionBm(torch.autograd.Function):
    """Batch-major dual attention (q/k/v/c [N, S, d], mask_bs [N, S],
    m1/m2 [N, S, S]) with K3 as forward and K4 as backward (or their
    plain versions on the CPU): the counterpart of ``_fused``."""

    @staticmethod
    def forward(ctx, q, k, v, c, mask_bs, m1, m2, beta, keep, use_dropout):
        out = dual_attention_bm_forward(
            q, k, v, c, mask_bs, m1, m2, beta, keep, use_dropout
        )
        ctx.save_for_backward(q, k, v, c, mask_bs, m1, m2)
        ctx.hyper = (beta, keep, use_dropout)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, c, mask_bs, m1, m2 = ctx.saved_tensors
        dq, dk, dv, dc = dual_attention_bm_backward(
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


def dual_attention_pallas(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    ctx: torch.Tensor,
    additive_mask: Optional[torch.Tensor],
    beta: float,
    dropout_rate: float,
    deterministic: bool,
    generator: Optional[torch.Generator],
) -> torch.Tensor:
    """Batch-major dual attention over [B, h, S, d] inputs → [B, h, S, d]
    (the counterpart of ``pmgt_tpu.ops.dual_attention_pallas``, the
    drop-in for the plain formulation). Heads fold into the batch:
    ``additive_mask`` [B, 1, 1, S] (or broadcastable; None = zeros) becomes
    [B·h, S]; with dropout on, the keep masks m1 then m2 [B·h, S, S] are
    drawn from ``generator`` (``uniform < 1 - dropout_rate``), which is then
    required. CPU tensors run the plain versions; CUDA tensors launch K3
    forward and K4 backward or raise."""
    b, h, s, d = query.shape
    q, k, v, c = (x.reshape(b * h, s, d) for x in (query, key, value, ctx))
    if additive_mask is not None:
        mask = torch.broadcast_to(additive_mask, (b, h, 1, s)).reshape(b * h, s)
    else:
        mask = torch.zeros((b * h, s), dtype=q.dtype, device=q.device)
    use_dropout = (not deterministic) and dropout_rate > 0.0
    keep = 1.0 - dropout_rate
    m1 = m2 = None
    if use_dropout:
        if generator is None:
            raise ValueError(
                "a generator is required when dropout_rate > 0 and "
                "deterministic=False"
            )
        dev = generator.device
        m1 = torch.rand((b * h, s, s), generator=generator, device=dev) < keep
        m2 = torch.rand((b * h, s, s), generator=generator, device=dev) < keep
    out = DualAttentionBm.apply(
        q, k, v, c, mask, m1, m2, float(beta), float(keep), use_dropout
    )
    return out.reshape(b, h, s, d)


def launch_counts() -> dict:
    """The four kernels' launch counters: {"k1", "k2", "k3", "k4"}."""
    return {k: tracing.counter(k + "_launches") for k in ("k1", "k2", "k3", "k4")}
