"""MCN contextual-neighborhood sampling (counterpart of
``pmgt_tpu/sampling/mcn.py``).

Hop-wise weighted neighbor draws with replacement (Walker alias tables
over softmax(edge weights)), frequency scoring with hop weight
``depth - k``, and the top ``max_ctx_neigh`` nodes by score as the
context, ties broken by the lowest node id.

- ``sample_context`` (production): alias draws, then segment scoring over
  the id-sorted draws, so the working set is [B, draws], not [B, N].
- ``sample_context_dense`` (cross-check): categorical draws over the
  padded weight logits and dense [B, N] scatter scoring.

Randomness enters either through a ``torch.Generator`` or as explicit
uniforms: ``draws[k]`` is the ``[B, F_k, hop_sampling_sizes[k]]`` float32
uniform array of hop k, the same array the JAX sampler draws with
``uniform(split(key, depth)[k], (B, F_k, num))``. Given JAX's uniforms the
outputs match JAX's exactly.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from pmgt_tpu_torch.core.config import SamplingConfig
from pmgt_tpu_torch.core.mesh import rand
from pmgt_tpu_torch.graph.container import (
    NUM_SPECIAL_NODES,
    DeviceGraph,
    PaddedGraph,
)


def topk_lowest_index(scores: torch.Tensor, k: int):
    """Top-k over the last axis with ties broken by the lowest index —
    the order ``jax.lax.top_k`` gives. ``torch.topk`` promises no order
    on ties, so this takes a stable descending sort instead. With fewer
    than k columns the missing ones come back as (-inf, position 0), as
    the JAX sampler's iterated argmax gives them; callers mask them."""
    vals, pos = torch.sort(scores, dim=-1, descending=True, stable=True)
    short = k - scores.shape[-1]
    if short > 0:
        vals = torch.nn.functional.pad(vals, (0, short), value=float("-inf"))
        pos = torch.nn.functional.pad(pos, (0, short), value=0)
    return vals[..., :k], pos[..., :k]


def alias_draw(
    graph: DeviceGraph, frontier: torch.Tensor, u: torch.Tensor
) -> torch.Tensor:
    """One weighted neighbor per uniform: frontier [B, F] node ids,
    u [B, F, num] uniforms in [0, 1) → [B, F * num] node ids.

    The slot is ``min(int(u * deg), deg - 1)`` and the acceptance uniform
    is the fractional part ``u * deg - slot``; the slot's primary neighbor
    is taken if it is below the slot's accept probability, else its alias.
    """
    b, f = frontier.shape
    deg = torch.clamp(graph.degrees[frontier], min=1)[..., None]  # [B,F,1]
    scaled = u * deg.to(u.dtype)
    slot = torch.minimum(scaled.to(torch.int64), deg - 1)
    frac = scaled - slot.to(scaled.dtype)
    flat = frontier[..., None] * graph.max_degree + slot  # [B, F, num]
    primary, alias, prob = graph.rows(
        (graph.alias_primary, graph.alias_alias, graph.alias_prob), flat)
    sampled = torch.where(frac < prob, primary, alias)
    return sampled.reshape(b, -1)


def _hop_uniforms(
    k: int,
    shape: Tuple[int, ...],
    device: torch.device,
    generator: Optional[torch.Generator],
    draws: Optional[Sequence[torch.Tensor]],
) -> torch.Tensor:
    if draws is not None:
        u = torch.as_tensor(draws[k], dtype=torch.float32, device=device)
        if tuple(u.shape) != shape:
            raise ValueError(
                f"draws[{k}] has shape {tuple(u.shape)}, expected {shape}"
            )
        return u
    return rand(shape, generator, device)


def sample_context(
    graph: DeviceGraph,
    targets: torch.Tensor,
    cfg: SamplingConfig,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample contextual neighborhoods for a batch of target nodes.

    Args:
        graph: device view of the graph (``PaddedGraph.to``).
        targets: [B] node ids (real nodes are >= 2).
        cfg: sampling configuration.
        generator: source of the uniforms when ``draws`` is None.
        draws: optional explicit per-hop uniforms (see module docstring).

    Returns:
        node_ids: [B, 1 + max_ctx_neigh] int64 — the target, then context
            nodes by descending score (ties: lowest id first), 0-padded.
        attention_mask: [B, 1 + max_ctx_neigh] float32.
    """
    targets = targets.to(torch.int64)
    batch = targets.shape[0]
    depth = len(cfg.hop_sampling_sizes)
    device = targets.device

    frontier = targets[:, None]
    all_ids, all_ws = [], []
    for k, num in enumerate(cfg.hop_sampling_sizes):
        u = _hop_uniforms(
            k, (batch, frontier.shape[1], num), device, generator, draws
        )
        sampled = alias_draw(graph, frontier, u)
        # hop weight (depth - k) for 0-based k
        all_ids.append(sampled)
        all_ws.append(torch.full(sampled.shape, depth - k, device=device))
        frontier = sampled

    ids = torch.cat(all_ids, dim=1)  # [B, T]
    ws = torch.cat(all_ws, dim=1)  # [B, T] int64
    # The target itself and the special ids never score.
    ws = torch.where(
        (ids == targets[:, None]) | (ids < NUM_SPECIAL_NODES), 0, ws
    )

    # Segment scoring over the draws sorted by id: the small integer
    # weights ride the sort in the low bits of (id << m_bits) | w.
    m_bits = depth.bit_length()
    spacked, _ = torch.sort((ids << m_bits) | ws, dim=1)
    sid = spacked >> m_bits
    sw = (spacked & ((1 << m_bits) - 1)).to(torch.float32)
    csum = torch.cumsum(sw, dim=1)
    ecsum = csum - sw  # exclusive cumsum
    change = sid[:, 1:] != sid[:, :-1]
    ones = torch.ones((batch, 1), dtype=torch.bool, device=device)
    first = torch.cat([ones, change], dim=1)
    last = torch.cat([change, ones], dim=1)
    # Weights are >= 0, so csum is nondecreasing and a running max
    # carries each segment's start to all its positions.
    neg_inf = torch.tensor(float("-inf"), device=device)
    start_ecsum = torch.cummax(torch.where(first, ecsum, neg_inf), dim=1)[0]
    seg_score = csum - start_ecsum  # valid at segment-end positions
    scores = torch.where(last & (seg_score > 0.0), seg_score, neg_inf)

    top_vals, top_pos = topk_lowest_index(scores, cfg.max_ctx_neigh)
    valid = top_vals > 0.0
    ctx_ids = torch.where(valid, torch.gather(sid, 1, top_pos), 0)

    node_ids = torch.cat([targets[:, None], ctx_ids], dim=1)
    attention_mask = torch.cat(
        [
            torch.ones((batch, 1), dtype=torch.float32, device=device),
            valid.to(torch.float32),
        ],
        dim=1,
    )
    return node_ids, attention_mask


def sample_context_dense(
    graph: PaddedGraph,
    targets: torch.Tensor,
    cfg: SamplingConfig,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Categorical draws over the padded weight logits + dense [B, N]
    scatter scoring + top-k over all nodes (the original formulation,
    kept as a cross-check of ``sample_context``; O(B·N) memory)."""
    device = targets.device
    targets = targets.to(torch.int64)
    nbr_ids = torch.as_tensor(graph.nbr_ids, device=device).to(torch.int64)
    probs_all = torch.softmax(
        torch.as_tensor(graph.nbr_logits, device=device), dim=-1
    )
    n_total, d = nbr_ids.shape
    batch = targets.shape[0]
    depth = len(cfg.hop_sampling_sizes)

    scores = torch.zeros((batch, n_total), dtype=torch.float32, device=device)
    frontier = targets[:, None]
    for k, num in enumerate(cfg.hop_sampling_sizes):
        f = frontier.shape[1]
        draws = torch.multinomial(
            probs_all[frontier].reshape(-1, d), num, replacement=True,
            generator=generator,
        ).reshape(batch, f, num)
        sampled = torch.gather(
            nbr_ids[frontier], 2, draws
        ).reshape(batch, -1)
        scores.scatter_add_(
            1, sampled,
            torch.full(sampled.shape, float(depth - k), device=device),
        )
        frontier = sampled

    scores[:, :NUM_SPECIAL_NODES] = 0.0
    scores.scatter_(1, targets[:, None], 0.0)

    top_vals, top_ids = topk_lowest_index(scores, cfg.max_ctx_neigh)
    valid = top_vals > 0.0
    ctx_ids = torch.where(valid, top_ids, 0)
    node_ids = torch.cat([targets[:, None], ctx_ids], dim=1)
    attention_mask = torch.cat(
        [
            torch.ones((batch, 1), dtype=torch.float32, device=device),
            valid.to(torch.float32),
        ],
        dim=1,
    )
    return node_ids, attention_mask


def complement_rank_select(
    sorted_rows: torch.Tensor,
    rank: torch.Tensor,
    lo: int,
    hi: int,
) -> torch.Tensor:
    """The rank-th smallest id in [lo, hi) NOT present in the row's sorted
    member set, clamped to hi - 1 when the complement is empty.

    Order-statistics walk: ``ans`` starts at ``lo + rank`` and is bumped
    past every member <= ans, members visited in ascending order. Members
    are sorted ascending and distinct; pads must be >= hi.

    Args:
        sorted_rows: [M, W] ascending member ids, padded with >= hi.
        rank: [M, K] integer ranks.
    Returns:
        [M, K] int64 ids.
    """
    ans = lo + rank.to(torch.int64)
    for j in range(sorted_rows.shape[1]):
        ans = ans + (sorted_rows[:, j : j + 1] <= ans).to(torch.int64)
    return torch.clamp(ans, max=hi - 1)
