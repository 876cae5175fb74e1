"""Checks of the sampler's draws by what they promise, from the raw edges.

The contexts and pairs are random draws made by the program's sampler
(Walker alias tables, its own generator); the plain reference cannot
redraw them, so it takes the drawn rows as given and holds each to the
sampler's guarantees (reference ``pmgt/datasets.py``, the port's
``sampling/mcn.py`` and ``sampling/pairs.py``):

- a context row: the node itself at position 0 with mask 1; then up to
  ``max_ctx_neigh`` distinct real nodes, each other than the node and
  within ``depth`` hops of it, as a prefix of mask-1 slots, 0-padded;
- a training pair row: ``min(max_pos, degree)`` distinct neighbours
  labelled 1 first, then real non-neighbours labelled 0, every slot valid.
"""
from __future__ import annotations

import warnings
from typing import Sequence

import numpy as np
import torch

NUM_SPECIAL_NODES = 2


def adjacency(num_nodes: int, edges: np.ndarray, device) -> torch.Tensor:
    """The symmetric 0/1 adjacency over table ids (node + 2), sparse."""
    e = torch.as_tensor(edges, dtype=torch.int64) + NUM_SPECIAL_NODES
    e = e[e[:, 0] != e[:, 1]]
    idx = torch.cat([e, e.flip(1)]).t()
    n = num_nodes + NUM_SPECIAL_NODES
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the invariant checks' notice: the indices are in range
        a = torch.sparse_coo_tensor(idx, torch.ones(idx.shape[1]), (n, n)).coalesce()
        a = torch.sparse_coo_tensor(a.indices(), torch.ones_like(a.values()), (n, n))
    return a.to(device)


def within_hops(adj: torch.Tensor, rows: torch.Tensor, depth: int, block: int = 2048) -> torch.Tensor:
    """bool [len(rows), N + 2]: which ids lie 1 to ``depth`` hops from each
    row's node."""
    n = adj.shape[0]
    out = []
    for s in range(0, len(rows), block):
        r = rows[s:s + block]
        x = torch.zeros((n, len(r)), device=adj.device)
        x[r, torch.arange(len(r), device=adj.device)] = 1.0
        reach = torch.zeros_like(x, dtype=torch.bool)
        for _ in range(depth):
            x = torch.clamp(torch.sparse.mm(adj, x), max=1.0)
            reach |= x > 0
        out.append(reach.t())
    return torch.cat(out)


def context_violations(adj, ids: torch.Tensor, mask: torch.Tensor, nodes: torch.Tensor,
                       depth: int) -> int:
    """Rows of (ids [R, S], mask [R, S]) drawn for ``nodes`` [R] that break
    a context's guarantees."""
    ids, mask, nodes = ids.to(adj.device), mask.to(adj.device), nodes.to(adj.device)
    bad = (ids[:, 0] != nodes) | (mask[:, 0] != 1)
    ctx, cm = ids[:, 1:], mask[:, 1:]
    bad |= ((cm == 1) != (ctx != 0)).any(1)
    bad |= (cm[:, 1:] > cm[:, :-1]).any(1)  # valid slots form a prefix
    real = ctx != 0
    bad |= (real & ((ctx < NUM_SPECIAL_NODES) | (ctx == nodes[:, None]))).any(1)
    srt = torch.sort(torch.where(real, ctx, -torch.arange(1, ctx.shape[1] + 1, device=ctx.device)), 1)[0]
    bad |= (srt[:, 1:] == srt[:, :-1]).any(1)
    uniq, inv = torch.unique(nodes, return_inverse=True)
    reach = within_hops(adj, uniq, depth)[inv]
    ok = torch.gather(reach, 1, torch.clamp(ctx, min=0)) | ~real
    bad |= ~ok.all(1)
    return int(bad.sum())


def pair_violations(adj, targets: torch.Tensor, pair_nodes: torch.Tensor, labels: torch.Tensor,
                    valid: torch.Tensor, max_pos: int, num_nodes: int) -> int:
    """Training pair rows ([R, P]) of ``targets`` [R] that break the pair
    draw's guarantees."""
    dev = adj.device
    targets, pair_nodes = targets.to(dev), pair_nodes.to(dev)
    labels, valid = labels.to(dev), valid.to(dev)
    uniq, inv = torch.unique(targets, return_inverse=True)
    nbr = within_hops(adj, uniq, 1)[inv]
    deg = nbr.sum(1)
    npos = torch.clamp(deg, max=max_pos)
    slot = torch.arange(pair_nodes.shape[1], device=dev)[None, :]
    is_pos = slot < npos[:, None]
    in_range = (pair_nodes >= NUM_SPECIAL_NODES) & (pair_nodes < num_nodes + NUM_SPECIAL_NODES)
    is_nbr = torch.gather(nbr, 1, torch.clamp(pair_nodes, 0, nbr.shape[1] - 1))
    bad = ~in_range.all(1)
    bad |= (labels != is_pos.float()).any(1)
    bad |= (valid != 1).any(1)
    bad |= (is_pos & ~is_nbr).any(1) | (~is_pos & is_nbr).any(1)
    pos_ids = torch.where(is_pos, pair_nodes, -1 - slot)
    srt = torch.sort(pos_ids, 1)[0]
    bad |= ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any(1)
    return int(bad.sum())


def negative_violations(users: Sequence[int], items: Sequence[int], labels: Sequence[float],
                        positives: dict) -> int:
    """Training examples whose label disagrees with the user's training
    positives (a drawn negative that is a positive, or a positive that is
    not one)."""
    bad = 0
    for u, i, y in zip(users, items, labels):
        bad += int((i in positives.get(u, ())) != (y == 1.0))
    return bad
