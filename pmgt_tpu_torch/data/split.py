"""Random train/test split of an array's rows, shared by the node split of
PMGT pre-training and the interaction-pair split of the downstream tasks.

``train_test_split`` makes the split sklearn's ``train_test_split(rows,
test_size=test_size, random_state=seed)`` makes: one
``RandomState(seed)`` permutation of the rows, the first ``ceil(test_size
* n)`` positions are the test set and the rest, in permutation order, the
train set. It is written out so the port needs no sklearn.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def train_test_split(
    rows: np.ndarray, test_size: float, seed: int
) -> Tuple[np.ndarray, np.ndarray]:
    """(train, test) rows of ``rows`` (split along the first axis)."""
    rows = np.asarray(rows)
    n_test = math.ceil(test_size * len(rows))
    perm = np.random.RandomState(seed).permutation(len(rows))
    return rows[perm[n_test:]], rows[perm[:n_test]]
