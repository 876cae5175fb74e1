"""Optimizer and learning-rate schedules (counterpart of
``pmgt_tpu/train/optim.py``, which builds them with optax).

- ``no_decay_mask``: weight decay for every parameter except biases and
  LayerNorm weights (the reference's no-decay group ``["bias",
  "LayerNorm.weight"]``). Position and role embeddings are decayed.
- ``make_schedule``: the transformers-style schedules, each value the one
  optax's schedule gives at step t, t counted from 0 (a warmup's first
  step has lr 0).
- ``make_optimizer``: AdamW (b1 0.9, b2 0.999, eps 1e-8) in two parameter
  groups, or SGD, behind an optional global-norm clip computed as optax's
  ``clip_by_global_norm`` does (``g * max_norm / |g|`` when ``|g| >=
  max_norm``; no epsilon, unlike ``torch.nn.utils.clip_grad_norm_``).
  The clip and the step stay on the device: no host sync.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

Schedule = Callable[[int], float]


def no_decay_mask(model: nn.Module) -> Dict[str, bool]:
    """{parameter name: True to apply weight decay}; False for biases and
    LayerNorm weights (flax's LayerNorm ``scale``)."""
    norm_weights = {
        f"{name}.weight" if name else "weight"
        for name, mod in model.named_modules()
        if isinstance(mod, nn.LayerNorm)
    }
    return {
        name: not (name.endswith("bias") or name in norm_weights)
        for name, _ in model.named_parameters()
    }


def _polynomial(init: float, end: float, power: float, steps: int) -> Schedule:
    if steps <= 0:
        return lambda t: init

    def schedule(t):
        frac = 1.0 - min(max(t, 0), steps) / steps
        return (init - end) * frac**power + end

    return schedule


def _cosine(init: float, steps: int) -> Schedule:
    def schedule(t):
        t = min(t, steps)
        return init * 0.5 * (1.0 + math.cos(math.pi * t / steps))

    return schedule


def _join(schedules, boundaries) -> Schedule:
    """optax.join_schedules: the last boundary passed picks the schedule,
    which sees the steps since that boundary."""

    def schedule(t):
        out = schedules[0](t)
        for boundary, s in zip(boundaries, schedules[1:]):
            if t >= boundary:
                out = s(t - boundary)
        return out

    return schedule


def make_schedule(
    lr: float,
    scheduler_type: Optional[str],
    total_steps: int,
    warmup_ratio: Optional[float] = None,
) -> Schedule:
    """transformers-style schedules, as the JAX package builds them."""
    warmup_steps = int(total_steps * warmup_ratio) if warmup_ratio else 0
    decay_steps = max(total_steps - warmup_steps, 1)

    if scheduler_type in (None, "constant", "constant_with_warmup"):
        body = lambda t: lr  # noqa: E731
    elif scheduler_type == "linear":
        body = _polynomial(lr, 0.0, 1.0, decay_steps)
    elif scheduler_type == "cosine":
        body = _cosine(lr, decay_steps)
    elif scheduler_type == "cosine_with_restarts":
        num_cycles = 3
        cycle = max(decay_steps // num_cycles, 1)
        body = _join(
            [_cosine(lr, cycle) for _ in range(num_cycles)],
            [cycle * (i + 1) for i in range(num_cycles - 1)],
        )
    elif scheduler_type == "polynomial":
        body = _polynomial(lr, 1e-7, 1.0, decay_steps)
    else:
        raise ValueError(f"unknown scheduler_type: {scheduler_type}")

    if warmup_steps > 0:
        return _join([_polynomial(0.0, lr, 1.0, warmup_steps), body], [warmup_steps])
    return body


class Optimizer:
    """A torch optimizer behind the schedule and the optional clip.
    ``step()`` reads the parameters' ``.grad``, clips them, sets each
    group's lr to ``schedule(count)`` and steps; ``count`` is the number
    of updates taken. ``state_dict`` / ``load_state_dict`` carry the inner
    optimizer's state and ``count``, so a resumed run continues the
    schedule where it stopped."""

    def __init__(
        self,
        inner: torch.optim.Optimizer,
        schedule: Schedule,
        gradient_max_norm: Optional[float] = None,
    ):
        self.inner = inner
        self.schedule = schedule
        self.max_norm = gradient_max_norm
        self.count = 0

    @property
    def params(self):
        return [p for g in self.inner.param_groups for p in g["params"]]

    def state_dict(self) -> Dict[str, Any]:
        return {"inner": self.inner.state_dict(), "count": self.count}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.inner.load_state_dict(state["inner"])
        self.count = int(state["count"])

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    @torch.no_grad()
    def clip(self) -> None:
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.max_norm is None or math.isinf(self.max_norm) or not grads:
            return
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads])
        )
        keep = norm < self.max_norm
        for g in grads:
            # (g / |g|) * max_norm, in optax's order, where clipped
            g.copy_(torch.where(keep, g, g / norm * self.max_norm))

    def step(self) -> None:
        self.clip()
        lr = float(self.schedule(self.count))
        for group in self.inner.param_groups:
            group["lr"] = lr
        self.inner.step()
        self.count += 1


def make_optimizer(
    model: nn.Module,
    optim: str = "adamw",
    lr: float = 1e-3,
    decay: float = 1e-2,
    scheduler_type: Optional[str] = None,
    total_steps: int = 1,
    warmup_ratio: Optional[float] = None,
    gradient_max_norm: Optional[float] = None,
) -> Optimizer:
    """AdamW with decay on the parameters ``no_decay_mask`` marks and none
    on the rest, or SGD; both behind the schedule and the optional clip."""
    schedule = make_schedule(lr, scheduler_type, total_steps, warmup_ratio)
    named = list(model.named_parameters())
    if optim == "adamw":
        mask = no_decay_mask(model)
        groups = [
            {"params": [p for n, p in named if mask[n]], "weight_decay": decay},
            {"params": [p for n, p in named if not mask[n]], "weight_decay": 0.0},
        ]
        inner = torch.optim.AdamW(
            [g for g in groups if g["params"]],
            lr=schedule(0), betas=(0.9, 0.999), eps=1e-8,
        )
    elif optim == "sgd":
        inner = torch.optim.SGD([p for _, p in named], lr=schedule(0))
    else:
        raise ValueError(f"unknown optimizer: {optim}")
    return Optimizer(inner, schedule, gradient_max_norm)
