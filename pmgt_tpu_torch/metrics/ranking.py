"""Host-side ranking metrics (counterpart of ``pmgt_tpu/metrics/ranking.py``).

``get_ndcg`` / ``get_recall`` keep the reference's semantics
(pmgt/metrics.py:16-37): predictions are ranked item ids, ground truth a
per-user set, NDCG's ideal DCG is that of ``min(#gt, top)`` hits, recall
counts each predicted id once. One deviation from the JAX package: its
membership test pads ground truth with -1, so a -1 prediction (the id
``export_topk`` gives an empty slot) scores a phantom hit; here a negative
prediction never hits.
"""
from __future__ import annotations

import logging
from typing import Sequence

import numpy as np

logger = logging.getLogger("pmgt_tpu_torch")

# Rows per [U, W, G] membership comparison.
_USER_CHUNK = 65_536


def _hit_matrix(prediction: np.ndarray, targets, top: int):
    """(hits [U, W] 0/1, first [U, W] first occurrence of each id in its
    row, gt_sizes [U]) with W = min(top, prediction width)."""
    tsets = [set(int(i) for i in t) for t in targets]
    pred = np.asarray(prediction)[:, :top].astype(np.int64, copy=False)
    u, w = pred.shape
    g = max((len(t) for t in tsets), default=1) or 1
    gt = np.full((u, g), -1, np.int64)
    for i, ts in enumerate(tsets):
        if ts:
            gt[i, : len(ts)] = sorted(ts)
    hits = np.empty((u, w), np.float64)
    first = np.empty((u, w), bool)
    dup_mask = np.tril(np.ones((w, w), bool), -1)
    for s in range(0, u, _USER_CHUNK):
        p = pred[s : s + _USER_CHUNK]
        hits[s : s + _USER_CHUNK] = (
            (p[:, :, None] == gt[s : s + _USER_CHUNK, None, :]).any(-1) & (p >= 0)
        )
        first[s : s + _USER_CHUNK] = ~((p[:, :, None] == p[:, None, :]) & dup_mask).any(-1)
    gt_sizes = np.fromiter((len(t) for t in tsets), np.int64, count=len(tsets))
    return hits, first, gt_sizes


def get_ndcg(prediction: np.ndarray, targets: Sequence[Sequence[int]], top: int = 5) -> float:
    """NDCG@top of ranked ids [U, >=1] against per-user relevant ids; a
    row narrower than ``top`` scores its width. Duplicate ids each count
    at their position (the reference's per-position binarizer)."""
    log = 1.0 / np.log2(np.arange(top) + 2)
    hits, _, gt_sizes = _hit_matrix(prediction, targets, top)
    dcg = hits @ log[: hits.shape[1]]
    denom = log.cumsum()[np.minimum(np.maximum(gt_sizes, 1), top) - 1]
    return float((dcg / denom).mean())


def get_recall(prediction: np.ndarray, targets: Sequence[Sequence[int]], top: int = 5) -> float:
    """Recall@top = |pred[:top] ∩ gt| / |gt|, averaged over users; each
    predicted id counts once."""
    hits, first, gt_sizes = _hit_matrix(prediction, targets, top)
    return float(((hits * first).sum(1) / np.maximum(gt_sizes, 1)).mean())


def stable_sigmoid(x: np.ndarray) -> np.ndarray:
    """Overflow-free sigmoid for host-side postprocessing."""
    x = np.asarray(x, dtype=np.float64)
    out = np.empty_like(x)
    pos = x >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-x[pos]))
    ex = np.exp(x[~pos])
    out[~pos] = ex / (1.0 + ex)
    return out


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Binary ROC-AUC via the rank statistic with tie-averaged ranks
    (numerically identical to sklearn.metrics.roc_auc_score). Returns 0
    when only one class is present."""
    labels = np.asarray(labels).astype(bool).ravel()
    scores = np.asarray(scores, dtype=np.float64).ravel()
    n_pos = int(labels.sum())
    n_neg = labels.size - n_pos
    if n_pos == 0 or n_neg == 0:
        logger.warning(
            "roc_auc: only one class present (%d pos / %d neg); returning 0",
            n_pos,
            n_neg,
        )
        return 0.0
    order = np.argsort(scores, kind="mergesort")
    sorted_scores = scores[order]
    # Group [i..j] of equal scores gets rank 0.5*(i+j)+1.
    n = labels.size
    starts_mask = np.r_[True, sorted_scores[1:] != sorted_scores[:-1]]
    group_start = np.flatnonzero(starts_mask)
    group_end = np.r_[group_start[1:], n]  # one past each group
    group_rank = 0.5 * (group_start + group_end - 1) + 1.0
    ranks = np.empty(n, dtype=np.float64)
    ranks[order] = group_rank[np.cumsum(starts_mask) - 1]
    pos_rank_sum = ranks[labels].sum()
    return float((pos_rank_sum - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))
