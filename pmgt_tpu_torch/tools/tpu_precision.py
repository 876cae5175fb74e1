"""The TPU's DEFAULT matmul precision, emulated in PyTorch for a bisect.

On a TPU, XLA runs an f32 dot at ``Precision.DEFAULT`` as one bf16 pass:
each operand rounded to bf16 (round to nearest even), the products summed
in f32. The JAX package sets no matmul precision, so its records taken on
a TPU v5e carry that arithmetic, in the forward pass and in both products
of every backward pass. Inside ``tpu_default_precision()`` every f32
``nn.Linear`` (``F.linear``) and every f32 ``a @ b`` whose second
operand is a matrix (the DCN's cross layers) runs that way here: operands rounded to
bf16, multiplied in f32 (exact: a bf16 product fits f32's mantissa) and
accumulated in f32, with TF32 off. The backward rounds the incoming
gradient and the saved operands the same way for ``dA = dC @ Bᵀ`` and
``dB = Aᵀ @ dC``.

This is a measuring instrument for ``chip_smoke.py --bisect
dcn-frozen-bf16``, not a mode of the port: no model, task, option or
config field reaches it.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the nearest bf16 value (ties to even), kept in its
    own dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


class _Bf16Matmul(torch.autograd.Function):
    """``a [..., k] @ b [k, n]`` from bf16-rounded operands in f32, with
    the TPU's backward: both products from bf16-rounded operands."""

    @staticmethod
    def forward(ctx, a, b):
        a16, b16 = bf16_round(a), bf16_round(b)
        ctx.save_for_backward(a16, b16)
        return torch.mm(a16.reshape(-1, a16.shape[-1]), b16).reshape(*a.shape[:-1], b.shape[1])

    @staticmethod
    def backward(ctx, grad):
        a16, b16 = ctx.saved_tensors
        g16 = bf16_round(grad).reshape(-1, grad.shape[-1])
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.mm(g16, b16.t()).reshape(a16.shape)
        if ctx.needs_input_grad[1]:
            db = torch.mm(a16.reshape(-1, a16.shape[-1]).t(), g16)
        return da, db


def bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _Bf16Matmul.apply(a, b)


# how ``a @ b`` reaches a TorchFunctionMode, by torch version
_MATMUL = (torch.Tensor.matmul, torch.Tensor.__matmul__)


class _TpuDefaultPrecision(TorchFunctionMode):
    """Routes f32 linears and ``a @ b`` through ``_Bf16Matmul``; ``calls``
    counts them (forward calls only)."""

    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is F.linear:
            x, weight = args[0], args[1]
            if x.dtype == weight.dtype == torch.float32:
                self.calls += 1
                bias = args[2] if len(args) > 2 else kwargs.get("bias")
                out = bf16_matmul(x, weight.t())
                return out if bias is None else out + bias  # the bias add is f32
        elif func in _MATMUL:
            a, b = args
            if a.dtype == b.dtype == torch.float32 and b.dim() == 2:
                self.calls += 1
                return bf16_matmul(a, b)
        return func(*args, **kwargs)


@contextlib.contextmanager
def tpu_default_precision() -> Iterator[_TpuDefaultPrecision]:
    """Every f32 linear and matrix product inside runs as XLA runs an f32
    dot at DEFAULT precision on a TPU (see the module's docstring). TF32 is
    switched off inside, so the f32 accumulation is f32's. Yields the mode,
    whose ``calls`` counts the products it rounded."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with _TpuDefaultPrecision() as mode:
            yield mode
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
