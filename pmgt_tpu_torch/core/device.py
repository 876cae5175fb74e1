"""Device resolution for the port's entry points, and the device memory
that the tasks budget against."""
from __future__ import annotations

import os
from typing import Optional, Union

import torch


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``torch.device(device)``, raising when CUDA is asked for and absent.

    Entry points default to ``"cuda"``; a machine without a GPU must fail
    loudly rather than silently run the plain CPU versions. The CPU runs
    only when the caller passes ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev


# Overrides the card's memory in the tasks' refresh budget (bytes), as
# PMGT_TPU_HBM_BYTES does the JAX package's nominal 16 GiB.
MEMORY_ENV = "PMGT_TORCH_HBM_BYTES"


def device_memory_bytes(device: Union[str, torch.device]) -> Optional[int]:
    """The device memory a task budgets against: ``PMGT_TORCH_HBM_BYTES``
    when set, else a card's total memory (the same from run to run,
    unlike its free memory), else None (the CPU: no budget)."""
    if os.environ.get(MEMORY_ENV):
        return int(os.environ[MEMORY_ENV])
    dev = torch.device(device)
    if dev.type == "cuda":
        return int(torch.cuda.get_device_properties(dev).total_memory)
    return None
