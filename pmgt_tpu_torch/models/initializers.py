"""flax's parameter initialisers, drawn from an explicit CPU
``torch.Generator`` into an existing tensor (counterparts of the
``nn.initializers`` the JAX package's downstream models use). Shapes are
torch's: a ``nn.Linear`` weight is [out, in], so fan_in is its second
dimension.

- ``normal_``: N(0, std) (``nn.initializers.normal``; the embeddings).
- ``uniform_``: U(-bound, bound).
- ``xavier_uniform_``: U(±sqrt(6 / (fan_in + fan_out))).
- ``lecun_normal_``: flax ``nn.Dense``'s default kernel init, a normal
  truncated at ±2 standard deviations whose variance is 1 / fan_in after
  the truncation (std sqrt(1 / fan_in) / 0.8796...).
"""
from __future__ import annotations

import math

import torch

# std of the standard normal truncated to [-2, 2]
_TRUNC2_STD = 0.87962566103423978


def _fill(p: torch.Tensor, values: torch.Tensor) -> None:
    with torch.no_grad():
        p.copy_(values.to(p.dtype))


def normal_(p: torch.Tensor, std: float, generator: torch.Generator) -> None:
    _fill(p, torch.randn(p.shape, generator=generator) * std)


def uniform_(p: torch.Tensor, bound: float, generator: torch.Generator) -> None:
    _fill(p, (torch.rand(p.shape, generator=generator) * 2.0 - 1.0) * bound)


def xavier_uniform_(w: torch.Tensor, generator: torch.Generator) -> None:
    fan_out, fan_in = w.shape
    uniform_(w, math.sqrt(6.0 / (fan_in + fan_out)), generator)


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """Truncated normal by the inverse CDF: u uniform between Φ(-2) and
    Φ(2), x = √2·erfinv(2u - 1)."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = lo + (1.0 - 2.0 * lo) * torch.rand(w.shape, generator=generator, dtype=torch.float64)
    x = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    std = math.sqrt(1.0 / w.shape[-1]) / _TRUNC2_STD
    _fill(w, x * std)
