"""The port's ranking metrics (``pmgt_tpu_torch.metrics.ranking``) against
the JAX package's on the same numpy inputs.

``get_ndcg`` and ``get_recall`` must equal ``pmgt_tpu.metrics.ranking``'s
(tolerance 1e-12: the same float64 sums) on predictions without -1: ranked
lists narrower and wider than ``top``, duplicate ids, ground-truth sets of
every size, empty predictions rows of padding ids. A -1 prediction is the
one documented deviation: the JAX membership test pads ground truth with
-1, so a -1 scores a phantom hit; the port never counts a negative id.
"""
from __future__ import annotations

import numpy as np
import pytest

from pmgt_tpu.metrics import ranking as jranking
from pmgt_tpu_torch.metrics import ranking as tranking

TOL = 1e-12


def _case(seed, users=200, width=30, items=50):
    rs = np.random.default_rng(seed)
    pred = rs.integers(0, items, size=(users, width))
    gts = [rs.choice(items, size=rs.integers(1, 12), replace=False).tolist()
           for _ in range(users)]
    return pred, gts


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("top", [1, 5, 10, 20, 50])
def test_ndcg_and_recall_match_the_jax_package(seed, top):
    pred, gts = _case(seed)
    assert abs(tranking.get_ndcg(pred, gts, top) - jranking.get_ndcg(pred, gts, top)) <= TOL
    assert abs(tranking.get_recall(pred, gts, top) - jranking.get_recall(pred, gts, top)) <= TOL


def test_duplicates_and_perfect_rankings_match():
    gts = [[3, 1], [7], [2, 4, 6]]
    pred = np.array([[1, 1, 3, 9], [7, 7, 7, 7], [6, 4, 2, 0]])
    for top in (1, 2, 3, 4, 8):
        assert tranking.get_ndcg(pred, gts, top) == pytest.approx(
            jranking.get_ndcg(pred, gts, top), abs=TOL)
        assert tranking.get_recall(pred, gts, top) == pytest.approx(
            jranking.get_recall(pred, gts, top), abs=TOL)
    # a perfect ranking scores 1 on both
    assert tranking.get_ndcg(np.array([[5, 6]]), [[6, 5]], 2) == pytest.approx(1.0)
    assert tranking.get_recall(np.array([[5, 6]]), [[6, 5]], 2) == pytest.approx(1.0)


def test_minus_one_prediction_never_hits():
    """The documented deviation: user 0's ground truth is padded with -1
    (user 1 has more relevant items), so the JAX metrics count its served
    -1 as a hit (recall 1.0); the port gives 0.5."""
    pred = np.array([[10, -1, -1], [20, 21, -1]])
    gts = [[10, 11], [5, 6, 7]]
    assert jranking.get_recall(pred, gts, 3) == pytest.approx(0.5)  # (1.0 + 0) / 2
    assert tranking.get_recall(pred, gts, 3) == pytest.approx(0.25)  # (0.5 + 0) / 2
    log = 1.0 / np.log2(np.arange(3) + 2)
    assert tranking.get_ndcg(pred, gts, 3) == pytest.approx(log[0] / log[:2].sum() / 2)
    assert jranking.get_ndcg(pred, gts, 3) > tranking.get_ndcg(pred, gts, 3)
