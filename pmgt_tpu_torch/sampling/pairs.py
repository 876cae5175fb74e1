"""Positive/negative pair sampling and batch assembly (counterpart of
``pmgt_tpu/sampling/pairs.py``).

- positives: ``min(max_total_samples - min_neg_samples, degree)`` direct
  neighbors drawn uniformly without replacement (top-k of uniform keys
  over the valid neighbor slots); eval draws 1 positive + 1 negative;
- negatives: exact uniform draws over the non-neighbor set [2, N+2) by
  order-statistics rank selection (``complement_rank_select``).

Randomness comes from a ``torch.Generator`` or, for the exact parity
tests, from explicit draws: ``u_pos`` [B, max_deg] uniforms and ``rank``
[B, P] integer ranks, the arrays the JAX sampler draws with
``uniform(key_pos, (B, D))`` and ``randint(key_neg, (B, P), 0, comp)``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from pmgt_tpu_torch.core.config import SamplingConfig
from pmgt_tpu_torch.core.mesh import rand
from pmgt_tpu_torch.core.tracing import span
from pmgt_tpu_torch.graph.container import NUM_SPECIAL_NODES, DeviceGraph
from pmgt_tpu_torch.sampling.mcn import (
    complement_rank_select,
    sample_context,
    topk_lowest_index,
)

# The whole-graph context refresh's default node chunk, and the ceiling
# of ``effective_refresh_chunk``: the refresh draws ``sample_context``
# over chunks of this many nodes, which bounds its transient (see
# ``refresh_transient_bytes``). Graphs of at most this many rows are drawn
# in one call.
REFRESH_CHUNK = 65_536
# The smallest chunk ``effective_refresh_chunk`` goes down to.
MIN_REFRESH_CHUNK = 8_192


def refresh_transient_bytes(cfg: SamplingConfig, chunk: int) -> int:
    """The most bytes ``sampling.mcn.sample_context`` holds at once while
    it draws the contexts of ``chunk`` nodes, counted from its code.

    With T = the draws of every hop a node (16 + 128 + 512 = 656 at hops
    16/8/4) and L = the last hop's (512), the live set peaks at the
    top-k sort of the scoring, where it holds per node:

    - eight int64 arrays of T: the hops' draws (``all_ids``) and their
      weights (``all_ws``), the concatenated ids and the masked weights,
      the packed sort's values and indices, the segment ids ``sid`` and
      the top-k sort's indices;
    - seven float32 arrays of T: the weights ``sw``, their cumsum and
      exclusive cumsum, the running max of segment starts, the segment
      scores, the masked scores and the top-k sort's values;
    - three bool arrays of T (``change``, ``first``, ``last``);
    - the last hop's float32 uniforms, L of them.

    That is 95·T + 4·L bytes a node: 64,368 at hops 16/8/4 (4.2 GB at
    65,536 nodes). The hop draws peak lower, at 57·L + 16·(T − L) bytes
    (the last hop's uniforms, scaled draws, slots, fractions, flat
    indices, the three alias-table gathers, the choice and the result
    beside the earlier hops' draws and weights), whatever the hops."""
    draws, width = [], 1
    for num in cfg.hop_sampling_sizes:
        width *= num
        draws.append(width)
    t = sum(draws)
    return int(chunk) * (95 * t + 4 * draws[-1])


def effective_refresh_chunk(
    graph: DeviceGraph, cfg: SamplingConfig, free_bytes: Optional[int] = None
) -> int:
    """The node chunk of the whole-graph refresh under a memory budget
    (counterpart of ``pmgt_tpu/sampling/pairs.py:41-81``).

    ``REFRESH_CHUNK`` when ``free_bytes`` is None (no budget known) or
    when two transients of that chunk fit in it; otherwise the chunk
    halves, in powers of two, until two fit, down to
    ``MIN_REFRESH_CHUNK``. A larger chunk is faster (fewer launches per
    refresh), so it shrinks only under memory pressure. The transient is
    the port's own (``refresh_transient_bytes``); ``graph`` is taken for
    the JAX signature's sake, since the port's sampler has one draw path.
    Callers pass ``free_bytes``: the device memory left after the
    persistent tables, the graph and the resident draws."""
    del graph
    chunk = REFRESH_CHUNK
    if free_bytes is None:
        return chunk
    while (chunk > MIN_REFRESH_CHUNK
           and 2 * refresh_transient_bytes(cfg, chunk) > free_bytes):
        chunk //= 2
    return chunk


class PretrainBatch(NamedTuple):
    """One fixed-shape PMGT batch. S = 1 + max_ctx_neigh; P = pairs per
    target (max_total_samples when training, 2 for eval)."""

    target_ids: torch.Tensor  # [B, S] int64
    target_mask: torch.Tensor  # [B, S] float32
    pair_ids: torch.Tensor  # [B, P, S] int64
    pair_mask: torch.Tensor  # [B, P, S] float32 (attention mask)
    labels: torch.Tensor  # [B, P] float32 (1 = pos, 0 = neg)
    pair_valid: torch.Tensor  # [B, P] float32 (0 = padded-out pair slot)


def sample_pairs(
    graph: DeviceGraph,
    targets: torch.Tensor,
    cfg: SamplingConfig,
    is_training: bool,
    generator: Optional[torch.Generator] = None,
    u_pos: Optional[torch.Tensor] = None,
    rank: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sample pos/neg pair nodes for each target.

    Returns:
        pair_nodes: [B, P] int64 node ids (pos slots first, then negs).
        labels: [B, P] float32.
        pair_valid: [B, P] float32 — 0 only when a pos slot could not be
            filled (isolated target in eval mode) or the complement is
            empty.
    """
    device = targets.device
    targets = targets.to(torch.int64)
    n_total = cfg.num_total or graph.num_total
    batch = targets.shape[0]

    max_pos = (
        cfg.max_total_samples - cfg.min_neg_samples if is_training else 1
    )
    total = cfg.max_total_samples if is_training else 2

    # --- positives: uniform without replacement over direct neighbors ---
    # [B, D] each: the neighbor rows and the ascending padded rows
    t_nbrs, t_sorted = graph.rows((graph.nbr_ids, graph.nbr_sorted), targets)
    t_deg = graph.degrees[targets]  # [B]
    d = t_nbrs.shape[1]
    if u_pos is None:
        u_pos = rand((batch, d), generator, device)
    else:
        u_pos = torch.as_tensor(u_pos, dtype=torch.float32, device=device)
    slots = torch.arange(d, device=device)
    valid_nbr = slots[None, :] < t_deg[:, None]
    rand_keys = torch.where(valid_nbr, u_pos, float("-inf"))
    k_eff = min(max_pos, d)
    _, pos_idx = topk_lowest_index(rand_keys, k_eff)  # [B, k_eff]
    pos_nodes = torch.gather(t_nbrs, 1, pos_idx)
    if k_eff < max_pos:
        pos_nodes = torch.nn.functional.pad(pos_nodes, (0, max_pos - k_eff))
    num_pos = torch.clamp(torch.clamp(t_deg, max=d), max=max_pos)  # [B]
    pos_slot = torch.arange(max_pos, device=device)[None, :] < num_pos[:, None]
    pos_nodes = torch.where(pos_slot, pos_nodes, 0)

    # --- negatives: exact uniform over the non-neighbor set -----------
    comp = n_total - NUM_SPECIAL_NODES - t_deg[:, None]  # [B, 1]
    if rank is None:
        hi = torch.clamp(comp, min=1).to(torch.float64)
        rank = rand((batch, total), generator, device, dtype=torch.float64)
        rank = torch.minimum((rank * hi).to(torch.int64), hi.to(torch.int64) - 1)
    else:
        rank = torch.as_tensor(rank, device=device).to(torch.int64)
    neg_nodes = complement_rank_select(
        t_sorted, rank, NUM_SPECIAL_NODES, n_total
    )
    neg_ok = (comp > 0).expand(batch, total).to(torch.float32)

    # --- pos slots first, negatives fill the rest ---------------------
    slot = torch.arange(total, device=device)[None, :]
    pos_padded = torch.nn.functional.pad(pos_nodes, (0, total - max_pos))
    is_pos = slot < num_pos[:, None]
    pair_nodes = torch.where(is_pos, pos_padded, neg_nodes)
    labels = is_pos.to(torch.float32)

    if is_training:
        pair_valid = torch.where(is_pos, 1.0, neg_ok)
    else:
        # Slot 0 is the positive (invalid if the target is isolated, and
        # then holds the neg candidate); slot 1 the negative.
        isolated = (slot == 0) & (num_pos[:, None] == 0)
        pair_valid = torch.where(
            isolated, 0.0, torch.where(is_pos, 1.0, neg_ok)
        )
        pair_nodes = torch.where(isolated, neg_nodes, pair_nodes)
    return pair_nodes, labels, pair_valid


def sample_all_contexts(
    graph: DeviceGraph,
    cfg: SamplingConfig,
    num_total: int,
    generator: Optional[torch.Generator] = None,
    chunk: int = REFRESH_CHUNK,
    draws: Optional[Sequence[Sequence[torch.Tensor]]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One context per node for ALL nodes → cache tables [N_total, S];
    rows 0/1 (the special ids) are context-free.

    The nodes are drawn in chunks of ``chunk`` (``REFRESH_CHUNK`` by
    default, or the task's ``effective_refresh_chunk`` under a memory
    budget), one ``sample_context`` call each, in order, from
    ``generator``; so for a given generator the table depends on the
    chunk only through where the chunks start. ``draws`` replaces the
    generator: ``draws[i]`` is chunk i's per-hop uniforms (see
    ``sample_context``), e.g. the JAX sampler's ``split(key, c)[i]``
    draws of that chunk's rows. Each chunk is a ``contexts`` span."""
    if chunk < 1:
        raise ValueError(f"refresh chunk must be at least 1, got {chunk}")
    device = graph.device
    all_nodes = torch.arange(num_total, device=device)
    ids_parts, mask_parts = [], []
    for i, start in enumerate(range(0, num_total, chunk)):
        with span("contexts", nodes=min(chunk, num_total - start)):
            ids, mask = sample_context(
                graph, all_nodes[start : start + chunk], cfg, generator,
                None if draws is None else draws[i],
            )
        ids_parts.append(ids)
        mask_parts.append(mask)
    ids = torch.cat(ids_parts)
    mask = torch.cat(mask_parts)
    ids[:NUM_SPECIAL_NODES, 1:] = 0
    mask[:NUM_SPECIAL_NODES, 1:] = 0.0
    return ids, mask


def sample_all_pairs(
    graph: DeviceGraph,
    cfg: SamplingConfig,
    num_total: int,
    is_training: bool = True,
    generator: Optional[torch.Generator] = None,
    chunk_size: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pos/neg pairs for ALL nodes once → tables [N_total, P]; the special
    rows are masked out. Each chunk of ``chunk_size`` nodes is a ``pairs``
    span."""
    device = graph.device
    parts = []
    for start in range(0, num_total, chunk_size):
        stop = min(start + chunk_size, num_total)
        with span("pairs", nodes=stop - start):
            parts.append(sample_pairs(graph, torch.arange(start, stop, device=device),
                                      cfg, is_training, generator))
    nodes, labels, valid = (torch.cat(p) for p in zip(*parts))
    valid[:NUM_SPECIAL_NODES] = 0.0
    return nodes, labels, valid


def make_pretrain_batch_cached(
    ctx_ids: torch.Tensor,  # [N_total, S] cached context table
    ctx_mask: torch.Tensor,  # [N_total, S]
    targets: torch.Tensor,
    pair_cache: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
) -> PretrainBatch:
    """Batch assembly from the per-phase caches: pure gathers."""
    all_nodes, all_labels, all_valid = pair_cache
    pair_nodes = all_nodes[targets]
    return PretrainBatch(
        target_ids=ctx_ids[targets],
        target_mask=ctx_mask[targets],
        pair_ids=ctx_ids[pair_nodes],  # [B, P, S]
        pair_mask=ctx_mask[pair_nodes],
        labels=all_labels[targets],
        pair_valid=all_valid[targets],
    )


def make_pretrain_batch(
    graph: DeviceGraph,
    targets: torch.Tensor,
    cfg: SamplingConfig,
    is_training: bool = True,
    generators: Optional[Sequence[torch.Generator]] = None,
    draws: Optional[Tuple] = None,
) -> PretrainBatch:
    """A batch with a fresh context for the target and for every pair node
    (per-step sampling, the reference's exact behaviour). Three streams, as
    JAX's three keys: ``generators`` = (target contexts, pairs, pair
    contexts), or ``draws`` = (the target contexts' per-hop uniforms,
    (u_pos, rank) of ``sample_pairs``, the pair contexts' per-hop
    uniforms) for the exact parity tests."""
    if draws is None:
        if generators is None or len(generators) != 3:
            raise ValueError("make_pretrain_batch needs three generators or the draws")
        g_ctx, g_pairs, g_pair_ctx = generators
        ctx_draws = pair_ctx_draws = None
        u_pos = rank = None
    else:
        g_ctx = g_pairs = g_pair_ctx = None
        ctx_draws, (u_pos, rank), pair_ctx_draws = draws
    batch = targets.shape[0]
    target_ids, target_mask = sample_context(graph, targets, cfg, g_ctx, ctx_draws)
    pair_nodes, labels, pair_valid = sample_pairs(
        graph, targets, cfg, is_training, g_pairs, u_pos=u_pos, rank=rank
    )
    p = pair_nodes.shape[1]
    pair_ids, pair_mask = sample_context(
        graph, pair_nodes.reshape(-1), cfg, g_pair_ctx, pair_ctx_draws
    )
    seq = target_ids.shape[1]
    return PretrainBatch(
        target_ids=target_ids,
        target_mask=target_mask,
        pair_ids=pair_ids.reshape(batch, p, seq),
        pair_mask=pair_mask.reshape(batch, p, seq),
        labels=labels,
        pair_valid=pair_valid,
    )
