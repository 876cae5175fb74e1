"""User-item interaction tables and the NCF/DCN sampling protocol
(counterpart of ``pmgt_tpu/data/interactions.py``).

``InteractionData`` is a padded structure-of-arrays view of a split: the
per-user positive items, sorted and unique, padded with ``num_items`` (an
id outside the item range, so a pad never matches a candidate). It is
host numpy, like the JAX package's.

Negatives are an exact uniform draw over each row's complement set — the
limit of the reference's rejection loop — by rank selection: a uniform
rank in ``[0, num_items - #positives)``, then the order-statistics walk
``sampling.mcn.complement_rank_select``. The ranks come from a
``torch.Generator`` or, for tests that hold the port against JAX draws,
as an explicit argument; the walk runs on the generator's device.

Membership is split-local, as in the reference: evaluation negatives are
checked only against the evaluated split's positives.
"""
from __future__ import annotations

import logging
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from pmgt_tpu_torch.data.split import train_test_split
from pmgt_tpu_torch.sampling.mcn import complement_rank_select

logger = logging.getLogger("pmgt_tpu_torch")

# Users per rank draw in build_eval_candidates: bounds the [users, L]
# draw tensors (L is max_sample_items = 1000 in the NCF protocol).
EVAL_USER_CHUNK = 4096


class InteractionData(NamedTuple):
    """Padded view of a (user, item) interaction split."""

    pairs: np.ndarray  # [M, 2] int32 (user, item) as given
    num_users: int
    num_items: int
    unique_users: np.ndarray  # [U] int32, sorted
    user_pos: np.ndarray  # [U, max_pos] int32, padded with num_items
    user_pos_count: np.ndarray  # [U] int32

    @classmethod
    def build(cls, pairs: np.ndarray, num_users: int, num_items: int) -> "InteractionData":
        pairs = np.asarray(pairs, np.int32).reshape(-1, 2)
        if len(pairs):
            for col, name, hi in ((0, "user", num_users), (1, "item", num_items)):
                lo_id, hi_id = pairs[:, col].min(), pairs[:, col].max()
                if lo_id < 0 or hi_id >= hi:
                    raise ValueError(
                        f"{name} ids in [{lo_id}, {hi_id}] outside [0, {hi})"
                    )
            # One lexsort; per-user rows come from the sorted run bounds.
            order = np.lexsort((pairs[:, 1], pairs[:, 0]))
            su, si = pairs[order, 0], pairs[order, 1]
            keep = np.ones(len(pairs), bool)
            keep[1:] = (su[1:] != su[:-1]) | (si[1:] != si[:-1])
            su, si = su[keep], si[keep]
            unique_users, starts = np.unique(su, return_index=True)
            pos_count = np.diff(np.append(starts, len(su))).astype(np.int32)
            u = len(unique_users)
            user_pos = np.full((u, max(int(pos_count.max()), 1)), num_items, np.int32)
            cols = np.arange(len(su)) - np.repeat(starts, pos_count)
            user_pos[np.repeat(np.arange(u), pos_count), cols] = si
        else:
            unique_users = np.zeros((0,), np.int32)
            pos_count = np.zeros((0,), np.int32)
            user_pos = np.full((0, 1), num_items, np.int32)
        return cls(
            pairs=pairs,
            num_users=int(num_users),
            num_items=int(num_items),
            unique_users=unique_users.astype(np.int32),
            user_pos=user_pos,
            user_pos_count=pos_count,
        )

    def user_row_index(self) -> np.ndarray:
        """[num_users] int32: user id → row in ``user_pos`` (0 for users
        absent from this split; callers index present users only)."""
        idx = np.zeros((self.num_users,), np.int32)
        idx[self.unique_users] = np.arange(len(self.unique_users), dtype=np.int32)
        return idx


def _draw_ranks(
    pair_rows: torch.Tensor, num_ng: int, num_items: int,
    generator: Optional[torch.Generator],
) -> torch.Tensor:
    """[M, num_ng] uniform integer ranks in [0, num_items - #positives of
    the row) (at least [0, 1)), on ``pair_rows``' device. A 62-bit draw
    reduced modulo the row's complement size: the bias is below 2^-40 at
    any item count."""
    n_pos = torch.sum(pair_rows < num_items, dim=1, keepdim=True)
    comp = torch.clamp(num_items - n_pos, min=1)
    raw = torch.randint(0, 2**62, (pair_rows.shape[0], num_ng),
                        generator=generator, device=pair_rows.device)
    return raw % comp


def ng_sample(
    pair_rows: Union[np.ndarray, torch.Tensor],
    num_ng: int,
    num_items: int,
    generator: Optional[torch.Generator] = None,
    rank: Optional[Union[np.ndarray, torch.Tensor]] = None,
) -> torch.Tensor:
    """``num_ng`` negative items per row, never one of the row's positives
    (reference ``ng_sample``, ncf/datasets.py:85-101).

    Args:
        pair_rows: [M, max_pos] sorted positive items per row, padded with
            ``num_items``.
        num_ng: negatives per row.
        num_items: item-id space size.
        generator: draws the ranks (on its device) when ``rank`` is None.
        rank: [M, num_ng] explicit ranks, each in [0, num_items -
            #positives of its row).

    Returns:
        [M, num_ng] int64 item ids on the generator's device (the CPU
        without one). A row whose positives
        cover every item has no negative; it gets a clamped id (callers
        warn on ``user_pos_count >= num_items``).
    """
    device = generator.device if generator is not None else "cpu"

    def on_device(x):  # (a copy of a numpy array: it may be read-only)
        return torch.as_tensor(np.array(x) if isinstance(x, np.ndarray) else x, device=device)

    rows = on_device(pair_rows)
    rank = _draw_ranks(rows, num_ng, num_items, generator) if rank is None else on_device(rank)
    return complement_rank_select(rows, rank, 0, num_items)


def _warn_degenerate_rows(data: InteractionData) -> None:
    n_bad = int((data.user_pos_count >= data.num_items).sum())
    if n_bad:
        logger.warning(
            "%d user(s) interacted with every item — no valid negative "
            "exists for them; their 'negatives' are clamped positives",
            n_bad,
        )


def epoch_training_arrays(
    data: InteractionData,
    num_ng: int,
    generator: Optional[torch.Generator] = None,
    negs: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One epoch of pointwise examples: every positive pair, then
    ``num_ng`` negatives per pair grouped per pair (the reference resamples
    each epoch, ncf/trainer.py:191-193).

    ``negs`` [M, num_ng] gives the negatives explicitly; otherwise they are
    drawn with ``generator``. Returns host (users, items, labels) of length
    M * (1 + num_ng): int32, int32, float32.
    """
    _warn_degenerate_rows(data)
    pairs = data.pairs
    m = len(pairs)
    users = pairs[:, 0]
    if m == 0 or num_ng == 0:
        return (users.astype(np.int32), pairs[:, 1].astype(np.int32),
                np.ones((m,), np.float32))
    if negs is None:
        rows = data.user_pos[data.user_row_index()[users]]
        negs = ng_sample(rows, num_ng, data.num_items, generator).cpu().numpy()
    negs = np.asarray(negs).reshape(m, num_ng)
    out_users = np.concatenate([users, np.repeat(users, num_ng)]).astype(np.int32)
    out_items = np.concatenate([pairs[:, 1], negs.reshape(-1)]).astype(np.int32)
    out_labels = np.concatenate(
        [np.ones((m,), np.float32), np.zeros((m * num_ng,), np.float32)]
    )
    return out_users, out_items, out_labels


def build_eval_candidates(
    data: InteractionData,
    num_ng: int,
    generator: Optional[torch.Generator] = None,
    reference_tiebreak: bool = False,
    negs: Optional[np.ndarray] = None,
    shuffle_seed: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-user ranking candidates: the user's positives first, then
    sampled negatives up to ``num_ng`` candidates (reference
    ncf/datasets.py:106-128; ``num_ng`` is ``max_sample_items``). A user
    with more positives than ``num_ng`` keeps them all and gets no
    negatives.

    Args:
        generator: draws the [U, L] negatives (``EVAL_USER_CHUNK`` users
            at a time) and then the shuffle seed, unless ``negs`` /
            ``shuffle_seed`` are given.
        reference_tiebreak: keep the reference's positives-first layout,
            so a tie-breaking top-k favours positives (its optimistic
            scoring of tied candidates; for comparisons with published
            numbers only). Default: shuffle each row's valid slots with
            ``np.random.default_rng(shuffle_seed)``, 8,192 rows at a time
            (padding keeps its tail position), so tied scores get their
            unbiased expectation.
        negs: [U, L] explicit negatives (L = max(num_ng, the largest
            positive count)).
        shuffle_seed: explicit seed of the row shuffle.

    Returns:
        users [U] int32 (the split's users, sorted), candidates [U, L]
        int32, cand_mask [U, L] float32 (1 on valid slots), labels [U, L]
        float32 (1 on positives).
    """
    _warn_degenerate_rows(data)
    users = data.unique_users
    u = len(users)
    counts = data.user_pos_count.astype(np.int64)
    if u == 0:
        z = np.zeros((0, max(num_ng, 1)), np.float32)
        return users, z.astype(np.int32), z, z
    valid = np.maximum(num_ng, counts)
    big_l = int(valid.max())
    if negs is None:
        negs = np.concatenate([
            ng_sample(data.user_pos[s : s + EVAL_USER_CHUNK], big_l,
                      data.num_items, generator).cpu().numpy()
            for s in range(0, u, EVAL_USER_CHUNK)
        ])
    negs = np.asarray(negs).reshape(u, big_l)
    col = np.arange(big_l)[None, :]
    pos_padded = np.full((u, big_l), data.num_items, np.int32)
    pos_padded[:, : data.user_pos.shape[1]] = data.user_pos
    is_pos = col < counts[:, None]
    candidates = np.where(is_pos, pos_padded, negs).astype(np.int32)
    labels = is_pos.astype(np.float32)
    cand_mask = (col < valid[:, None]).astype(np.float32)
    if reference_tiebreak:
        return users, candidates, cand_mask, labels
    if shuffle_seed is None:
        shuffle_seed = int(torch.randint(0, np.iinfo(np.int32).max, (1,),
                                         generator=generator,
                                         device=generator.device).item())
    rng = np.random.default_rng(shuffle_seed)
    for start in range(0, u, 8192):
        sl = slice(start, min(start + 8192, u))
        r = rng.random((sl.stop - sl.start, big_l), dtype=np.float32)
        r[cand_mask[sl] == 0] = np.inf
        order = np.argsort(r, axis=1, kind="stable")
        candidates[sl] = np.take_along_axis(candidates[sl], order, axis=1)
        labels[sl] = np.take_along_axis(labels[sl], order, axis=1)
    return users, candidates, cand_mask, labels


def train_valid_split(
    pairs: np.ndarray, valid_size: float, seed: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Random train/valid split of interaction pairs (reference
    ncf/trainer.py:53-60, sklearn's ``train_test_split``)."""
    pairs = np.asarray(pairs, np.int32).reshape(-1, 2)
    if valid_size <= 0 or len(pairs) < 2:
        return pairs, pairs[:0]
    train, valid = train_test_split(pairs, valid_size, seed)
    return np.ascontiguousarray(train), np.ascontiguousarray(valid)
