"""Host-side seeding (counterpart of ``pmgt_tpu/utils/base.py``).

The port's draws on the card come from explicit ``torch.Generator``s
seeded from ``args.seed``; ``set_seed`` pins the host's ``random`` and
numpy generators, as the JAX package's does. ``log_elapsed_time`` is in
``cli/main.py``.
"""
from __future__ import annotations

import random

import numpy as np


def set_seed(seed: int) -> None:
    """Seed the host's ``random`` and numpy global generators (reference
    utils/base.py:35-39)."""
    random.seed(seed)
    np.random.seed(seed)
