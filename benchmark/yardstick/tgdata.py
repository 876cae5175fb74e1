"""The benchmark's inputs: a frozen copy of the port's TG-shape dataset
generator and of its row split, in numpy alone.

Copied from ``pmgt_tpu_torch/data/synthetic.py`` (``PUBLISHED_SHAPES``,
``_popularity``, ``_cluster_samplers``, ``_draw_in_cluster``,
``_co_review_weights``, ``_powerlaw_edges``, ``_powerlaw_interactions``,
``make_published_shape_dataset``; sha256 aa57c06e9da8d8fcd9498dde71d3e3e5
ad64025bcbeb190100c06c1b31afd274) and ``pmgt_tpu_torch/data/split.py``
(``train_test_split``; sha256 3cd0e5653d91f0fbc4840617745fdf81bd364905f694
f5e0bbfb3a1b98ce3da2). The numpy streams are the originals', so a seed
gives the dataset the port's generator gives; what differs is the output:
raw edges, feature rows and interaction pairs, which the harness hands to
the program (through its own graph builder) and to the reference alike.
A later change to the port's generator does not move these inputs.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Sequence

import numpy as np

NUM_SPECIAL_NODES = 2  # rows 0 (<pad>) and 1 (<mask>) of every node table

# Exact counts of the two published datasets (reference README.md:129-167).
PUBLISHED_SHAPES = {
    "VG": dict(num_nodes=7252, num_users=27988, num_edges=88606, num_interactions=98278),
    "TG": dict(num_nodes=10834, num_users=134697, num_edges=38252, num_interactions=378138),
}
CALIBRATED_SIGNAL = {"VG": 0.6, "TG": 0.5}


class RawDataset(NamedTuple):
    num_nodes: int
    num_users: int
    edges: np.ndarray  # [E, 2] int64, zero-based node ids
    edge_weights: np.ndarray  # [E] float64
    feat_tables: list  # per modality [N + 2, F] float32, rows 0/1 zero
    train_pairs: np.ndarray  # [M, 2] int32 (user, item)
    test_pairs: np.ndarray  # [T, 2] int32


def _popularity(num_nodes, rng, gamma: float = 2.1, offset: float = 10.0):
    ranks = rng.permutation(num_nodes).astype(np.float64)
    w = (ranks + offset) ** (-1.0 / (gamma - 1.0))
    return w / w.sum()


def _cluster_samplers(members, pop):
    c = len(members)
    max_size = max(len(m) for m in members)
    mem_mat = np.zeros((c, max_size), np.int64)
    cum = np.ones((c, max_size), np.float64)
    for k, m in enumerate(members):
        mem_mat[k, : len(m)] = m
        p = pop[m]
        cum[k, : len(m)] = np.cumsum(p) / p.sum()
    return mem_mat, cum


def _draw_in_cluster(cids, mem_mat, cum, rng):
    u = rng.random(len(cids))[:, None]
    slot = np.argmax(cum[cids] >= u, axis=1)
    return mem_mat[cids, slot]


def _co_review_weights(n, rng):
    counts = 1.0 + np.floor(rng.pareto(1.5, size=n))
    return 1.0 + np.log(np.minimum(counts, 50.0))


def _powerlaw_edges(num_nodes, num_edges, cluster, members, pop, rng):
    mem_mat, cum = _cluster_samplers(members, pop)
    gcum = np.cumsum(pop)
    gcum /= gcum[-1]

    srcs = np.arange(num_nodes)
    multi = np.asarray([len(members[cluster[u]]) > 1 for u in srcs])
    backbone_v = np.where(
        multi, _draw_in_cluster(cluster[srcs], mem_mat, cum, rng), (srcs + 1) % num_nodes,
    )
    self_draw = backbone_v == srcs
    if self_draw.any():
        sizes = np.asarray([len(m) for m in members])
        pos_in_cluster = np.empty(num_nodes, np.int64)
        for m in members:
            pos_in_cluster[m] = np.arange(len(m))
        nxt = (pos_in_cluster + 1) % np.maximum(sizes[cluster], 1)
        backbone_v = np.where(self_draw & multi, mem_mat[cluster[srcs], nxt], backbone_v)
    edge_u, edge_v = [srcs], [backbone_v]

    for _ in range(12):
        uu = np.concatenate(edge_u)
        vv = np.concatenate(edge_v)
        key = np.minimum(uu, vv) * np.int64(num_nodes) + np.maximum(uu, vv)
        keep = uu != vv
        _, first = np.unique(key[keep], return_index=True)
        first.sort()
        edge_u, edge_v = [uu[keep][first]], [vv[keep][first]]
        short = num_edges - len(first)
        if short <= 0:
            break
        draw = max(int(short * 1.6), 1024)
        u = np.searchsorted(gcum, rng.random(draw))
        intra = rng.random(draw) < 0.85
        v = np.where(
            intra,
            _draw_in_cluster(cluster[u], mem_mat, cum, rng),
            np.searchsorted(gcum, rng.random(draw)),
        )
        edge_u.append(u)
        edge_v.append(v)
    uu, vv = edge_u[0][:num_edges], edge_v[0][:num_edges]
    ww = _co_review_weights(len(uu), rng)
    return np.stack([uu, vv], axis=1).astype(np.int64), ww


def _powerlaw_interactions(num_users, num_items, total, cluster, members, pop, rng,
                           alpha: float = 2.3, intra_prob: float = 0.8):
    mem_mat, cum = _cluster_samplers(members, pop)
    gcum = np.cumsum(pop)
    gcum /= gcum[-1]
    pref = rng.integers(0, len(members), size=num_users)

    sizes = np.floor((1.0 - rng.random(num_users)) ** (-1.0 / (alpha - 1.0))).astype(np.int64)
    sizes = np.minimum(sizes, 10 * max(total // num_users, 1))

    pairs = np.empty((0, 2), np.int64)
    for _ in range(12):
        short = total - len(pairs)
        if short <= 0:
            break
        scale = max(float(short) * 1.3 / max(sizes.sum(), 1), 1e-9)
        counts = rng.poisson(sizes * scale)
        users = np.repeat(np.arange(num_users), counts)
        n = len(users)
        if n == 0:
            continue
        intra = rng.random(n) < intra_prob
        items = np.where(
            intra,
            _draw_in_cluster(pref[users], mem_mat, cum, rng),
            np.searchsorted(gcum, rng.random(n)),
        )
        new = np.stack([users, items], axis=1)
        pairs = np.concatenate([pairs, new])
        key = pairs[:, 0] * np.int64(num_items) + pairs[:, 1]
        _, first = np.unique(key, return_index=True)
        first.sort()
        pairs = pairs[first]
    return pairs[:total]


def make_dataset(spec: Dict[str, int], seed: int, signal: float,
                 feat_dims: Sequence[int] = (1536, 768), num_clusters: int = 40) -> RawDataset:
    """The dataset of ``make_published_shape_dataset`` at the counts of
    ``spec`` (``num_nodes``, ``num_users``, ``num_edges``,
    ``num_interactions``): clustered power-law graph, cluster-centroid
    features (the first modality clipped at 0), power-law interactions and
    the reference's 80/20 interaction split."""
    num_nodes, num_users = int(spec["num_nodes"]), int(spec["num_users"])
    rng = np.random.default_rng(seed)

    c = min(num_clusters, num_nodes)
    cluster = rng.permutation(np.arange(num_nodes) % c).astype(np.int32)
    members = [np.flatnonzero(cluster == k) for k in range(c)]
    pop = _popularity(num_nodes, rng)

    edges, weights = _powerlaw_edges(num_nodes, int(spec["num_edges"]), cluster, members, pop, rng)

    feat_tables = []
    for i, dim in enumerate(feat_dims):
        centroids = rng.normal(size=(c, dim)).astype(np.float32)
        table = np.zeros((num_nodes + NUM_SPECIAL_NODES, dim), np.float32)
        noise = rng.normal(size=(num_nodes, dim)).astype(np.float32)
        rows = centroids[cluster] + 0.4 * noise
        if i == 0:
            rows = np.maximum(rows, 0.0)
        table[NUM_SPECIAL_NODES:] = rows
        feat_tables.append(table)

    pairs = _powerlaw_interactions(num_users, num_nodes, int(spec["num_interactions"]),
                                   cluster, members, pop, rng, intra_prob=0.8 * signal)
    perm = rng.permutation(len(pairs))
    n_test = int(round(len(pairs) * 0.2))
    test_idx, train_idx = perm[:n_test], perm[n_test:]
    return RawDataset(num_nodes, num_users, edges, weights, feat_tables,
                      pairs[train_idx].astype(np.int32), pairs[test_idx].astype(np.int32))


def train_test_split(rows: np.ndarray, test_size: float, seed: int):
    """(train, test) rows: one ``RandomState(seed)`` permutation, the first
    ``ceil(test_size * n)`` positions the test set (sklearn's split)."""
    rows = np.asarray(rows)
    n_test = math.ceil(test_size * len(rows))
    perm = np.random.RandomState(seed).permutation(len(rows))
    return rows[perm[n_test:]], rows[perm[:n_test]]


def neighbour_sets(num_nodes: int, edges: np.ndarray) -> list:
    """Each node's set of neighbours in table ids (node + 2), self-loops
    dropped: the graph as the plain reference reads it."""
    nbrs = [set() for _ in range(num_nodes + NUM_SPECIAL_NODES)]
    for u, v in edges.tolist():
        if u != v:
            nbrs[u + NUM_SPECIAL_NODES].add(v + NUM_SPECIAL_NODES)
            nbrs[v + NUM_SPECIAL_NODES].add(u + NUM_SPECIAL_NODES)
    return nbrs
