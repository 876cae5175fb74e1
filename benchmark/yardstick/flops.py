"""Floating-point operations that a step's or a request's outputs need,
from shapes, whatever implements them. A multiply-add counts 2.

- Encoder, per token and layer: the q, k, v, cosine-branch and output
  projections (5·2·H·H), the FFN pair (2·2·H·I), the attention's
  c·cᵀ, q·kᵀ and P·v (6·S·H), and per token the modality attention of the
  embeddings (2·(M·H)·M). A backward counts twice its forward.
- Frozen-table projection (each modality's F → H): once per distinct row
  a step or request touches (2·H·ΣF), not per token. In training its
  backward needs the weight gradient alone: once more.
- Towers of PMGT_NCF (NeuMF-end): the MLP layers, the GMF product and the
  prediction layer, once per (user, item) pair.
The heads of pre-training (GSR's dot products, NFR's projections of the
masked slots) are left out: the counts are a floor of the work.
"""
from __future__ import annotations

from typing import Sequence


def encoder_flops_per_token(hidden: int, intermediate: int, layers: int, seq: int,
                            feat_dims: Sequence[int]) -> int:
    m = len(feat_dims)
    per_layer = 5 * 2 * hidden * hidden + 2 * 2 * hidden * intermediate + 6 * seq * hidden
    return layers * per_layer + 2 * (m * hidden) * m


def projection_flops_per_row(hidden: int, feat_dims: Sequence[int]) -> int:
    return 2 * hidden * sum(feat_dims)


def tower_widths(factor: int, layers: int, hidden: int):
    """(in, out) of each MLP layer of PMGT_NCF: [user fn·2^(L−1) ; item H]
    first, each layer halving (reference pmgt_ncf/models.py:55-76)."""
    outs = [factor * 2 ** (layers - i) // 2 for i in range(layers)]
    ins = [factor * 2 ** (layers - 1) + hidden, *outs[:-1]]
    return list(zip(ins, outs))


def tower_flops_per_pair(factor: int, layers: int, hidden: int) -> int:
    widths = tower_widths(factor, layers, hidden)
    mlp = sum(2 * a * b for a, b in widths)
    return mlp + factor + 2 * (widths[-1][1] + factor)


def pretrain_step_flops(cfg: dict, lanes: int, distinct_rows: float) -> float:
    """One PMGT pre-training step: ``lanes`` sequences of S tokens through
    the encoder forward and backward, the projection of the distinct rows
    with its weight gradient."""
    s = 1 + cfg["max_ctx_neigh"]
    tok = encoder_flops_per_token(cfg["hidden_size"], cfg["intermediate_size"],
                                  cfg["num_hidden_layers"], s, cfg["feat_dims"])
    proj = projection_flops_per_row(cfg["hidden_size"], cfg["feat_dims"])
    return 3.0 * lanes * s * tok + 2.0 * distinct_rows * proj


def pmgt_ncf_train_step_flops(cfg: dict, pairs: int, distinct_rows: float) -> float:
    """One PMGT_NCF step: each pair's item sequence through the encoder
    (dropout differs per lane, so per lane), the towers, forward and
    backward; the projection of the distinct rows with its weight
    gradient."""
    s = 1 + cfg["max_ctx_neigh"]
    tok = encoder_flops_per_token(cfg["hidden_size"], cfg["intermediate_size"],
                                  cfg["num_hidden_layers"], s, cfg["feat_dims"])
    proj = projection_flops_per_row(cfg["hidden_size"], cfg["feat_dims"])
    tower = tower_flops_per_pair(cfg["factor_num"], cfg["num_layers"], cfg["hidden_size"])
    return 3.0 * pairs * (s * tok + tower) + 2.0 * distinct_rows * proj


def serve_request_flops(cfg: dict, users: int, items: int, distinct_rows: float) -> float:
    """One top-k request: every catalogue item encoded once, the towers
    once per (user, item) pair, the projection of the distinct rows."""
    s = 1 + cfg["max_ctx_neigh"]
    tok = encoder_flops_per_token(cfg["hidden_size"], cfg["intermediate_size"],
                                  cfg["num_hidden_layers"], s, cfg["feat_dims"])
    proj = projection_flops_per_row(cfg["hidden_size"], cfg["feat_dims"])
    tower = tower_flops_per_pair(cfg["factor_num"], cfg["num_layers"], cfg["hidden_size"])
    return float(items * s * tok + users * items * tower + distinct_rows * proj)
