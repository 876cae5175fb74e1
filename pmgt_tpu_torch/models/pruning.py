"""Attention-head pruning by parameter surgery (counterpart of
``pmgt_tpu/models/pruning.py``).

Removing heads shrinks the q/k/v/ctx projections' output rows and the
``attention_output`` projection's input columns; the kept heads compute
exactly what they did before. ``prune_attention_heads`` returns a new state
dict and the config of the pruned model (``head_dim_override`` keeps the
head width), which ``PMGTForPreTraining(new_config, ...)`` loads.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Sequence, Tuple

import torch

from pmgt_tpu_torch.core.config import PMGTConfig

_PROJ = re.compile(
    r"(^|.*\.)layers\.(\d+)\.self_attention\.(query|key|value|ctx_attention)\.(weight|bias)$"
)
_OUT = re.compile(r"(^|.*\.)layers\.(\d+)\.attention_output\.weight$")


def prune_attention_heads(
    state_dict: Dict[str, torch.Tensor],
    config: PMGTConfig,
    heads_to_prune: Dict[int, Sequence[int]],
) -> Tuple[Dict[str, torch.Tensor], PMGTConfig]:
    """Remove the heads ``heads_to_prune`` = {layer: [head, ...]} from a
    ``PMGTForPreTraining`` (keys ``bert.layers.*``) or ``PMGTModel``
    (``layers.*``) state dict. Every layer must lose the same number of
    heads, and at least one must stay. Returns (new state dict, new
    config); tensors not pruned are the same objects."""
    if not heads_to_prune:
        return state_dict, config
    counts = {len(set(v)) for v in heads_to_prune.values()}
    if len(counts) != 1 or set(heads_to_prune) != set(range(config.num_hidden_layers)):
        raise ValueError(
            "prune the same number of heads in every layer (uniform "
            "attention width is required by the shared hidden size)"
        )
    n_removed = counts.pop()
    if n_removed >= config.num_attention_heads:
        raise ValueError("cannot prune all heads")
    d = config.head_dim
    kept = {
        layer: torch.cat([
            torch.arange(h * d, (h + 1) * d)
            for h in range(config.num_attention_heads) if h not in set(heads)
        ])
        for layer, heads in heads_to_prune.items()
    }
    out = dict(state_dict)
    for name, t in state_dict.items():
        m = _PROJ.match(name)
        if m:
            out[name] = t[kept[int(m.group(2))].to(t.device)].clone()
            continue
        m = _OUT.match(name)
        if m:
            out[name] = t[:, kept[int(m.group(2))].to(t.device)].clone()
    new_config = dataclasses.replace(
        config, num_attention_heads=config.num_attention_heads - n_removed,
        head_dim_override=d,
    )
    return out, new_config
