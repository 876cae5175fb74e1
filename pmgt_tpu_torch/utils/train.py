"""The dynamic gradient clip (counterpart of ``pmgt_tpu/utils/train.py``).

``dynamic_clip_by_norm_history`` clips each step's gradients to ``mean +
clip_factor · std`` of a window of recent gradient norms instead of a
fixed threshold (the reference's ``clip_gradient``, utils/train.py:15-36).
As in the JAX package it is a utility: no CLI option reaches it, and the
fixed clip is ``make_optimizer(gradient_max_norm=...)``. The state is
explicit and stays on the gradients' device; nothing waits for the device.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch


class DynamicClipState(NamedTuple):
    norms: torch.Tensor  # [window] float32 ring buffer of recent norms
    count: torch.Tensor  # number of valid entries (int32)
    pos: torch.Tensor  # ring position (int32)


class DynamicClip(NamedTuple):
    """``init(device)`` → the empty state; ``update(grads, state)`` →
    (clipped gradients, new state)."""

    window: int
    clip_factor: float
    eps: float

    def init(self, device=None) -> DynamicClipState:
        return DynamicClipState(
            norms=torch.zeros((self.window,), dtype=torch.float32, device=device),
            count=torch.zeros((), dtype=torch.int32, device=device),
            pos=torch.zeros((), dtype=torch.int32, device=device),
        )

    def update(
        self, grads: Sequence[torch.Tensor], state: DynamicClipState
    ) -> Tuple[List[torch.Tensor], DynamicClipState]:
        """The global norm of ``grads`` against the window's threshold
        (the first step clips nothing); the recorded norm is the clipped
        one, min(norm, threshold)."""
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads])
        )
        device = state.norms.device
        valid = torch.arange(self.window, device=device) < torch.clamp(state.count, min=1)
        denom = torch.clamp(torch.sum(valid.to(torch.float32)), min=1.0)
        zero = torch.zeros((), dtype=state.norms.dtype, device=device)
        mean = torch.sum(torch.where(valid, state.norms, zero)) / denom
        var = torch.sum(torch.where(valid, (state.norms - mean) ** 2, zero)) / denom
        threshold = torch.where(
            state.count > 0,
            mean + self.clip_factor * torch.sqrt(var) + self.eps,
            norm + self.eps,
        )
        scale = torch.clamp(threshold / torch.clamp(norm, min=1e-12), max=1.0)
        clipped = [g * scale.to(g.dtype) for g in grads]
        norms = state.norms.clone()
        norms[state.pos.long()] = torch.minimum(norm, threshold).to(norms.dtype)
        new_state = DynamicClipState(
            norms=norms,
            count=torch.clamp(state.count + 1, max=self.window),
            pos=(state.pos + 1) % self.window,
        )
        return clipped, new_state


def dynamic_clip_by_norm_history(
    window: int = 10, clip_factor: float = 1.0, eps: float = 1e-2
) -> DynamicClip:
    """Clip each step's gradient to ``mean + clip_factor * std`` of the
    last ``window`` recorded norms (seeded with the first observation)."""
    return DynamicClip(window, clip_factor, eps)
