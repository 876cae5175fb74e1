"""Padded-CSR graph container (counterpart of ``pmgt_tpu/graph/container.py``).

Node-id space: 0 = <pad>, 1 = <mask>, real nodes are 2..N+1.

- ``nbr_ids[n, d]``    — d-th neighbor of node n (0 = <pad>)
- ``nbr_logits[n, d]`` — edge weight, ``-inf`` on padding
- ``degrees[n]``       — true neighbor count of node n
- ``alias_prob``/``alias_idx`` — Walker alias tables over
  softmax(edge weights), built with Vose's method
- the flat alias triple ``alias_primary`` / ``alias_alias`` /
  ``alias_prob_bits`` indexed by ``node * max_deg + slot``, with the alias
  slot pre-resolved to the alias neighbor id
- ``nbr_sorted`` — ascending neighbor ids padded with N+2, for the exact
  complement negative sampler

The TPU row layouts of the JAX package (``draw_packed16``, ``draw_packed``,
the one-hot slot selection) are not carried over: on the GPU the flat
triple is gathered directly, and the draws match those layouts' outputs
bit for bit. :meth:`PaddedGraph.to` gives the device view the samplers read.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from pmgt_tpu_torch.core.mesh import gather_rows

NEG_INF = float("-inf")
NUM_SPECIAL_NODES = 2  # 0 = <pad>, 1 = <mask>


class DeviceGraph(NamedTuple):
    """Torch tensors the samplers read, on one device. With ``mesh`` (a
    rank of a data-parallel group, ``core/mesh.place_graph``) the per-node
    tables hold the rank's row block and ``degrees`` stays whole; the
    samplers read every per-node row through ``rows``."""

    nbr_ids: torch.Tensor  # [N+2, max_deg] int64
    degrees: torch.Tensor  # [N+2] int64
    alias_primary: torch.Tensor  # [(N+2)*max_deg] int64
    alias_alias: torch.Tensor  # [(N+2)*max_deg] int64
    alias_prob: torch.Tensor  # [(N+2)*max_deg] float32
    nbr_sorted: torch.Tensor  # [N+2, max_deg] int64
    mesh: Optional[Any] = None  # the group the tables are row-sharded over
    rows_total: int = 0  # N+2 when sharded (the blocks are padded)

    tensor_fields = ("nbr_ids", "degrees", "alias_primary", "alias_alias", "alias_prob",
                     "nbr_sorted")

    @property
    def num_total(self) -> int:
        return self.rows_total if self.mesh is not None else int(self.nbr_ids.shape[0])

    @property
    def max_degree(self) -> int:
        return int(self.nbr_ids.shape[1])

    @property
    def device(self) -> torch.device:
        return self.nbr_ids.device

    @property
    def nbytes(self) -> int:
        """Device bytes of the tables (a sharded graph's blocks)."""
        return sum(t.numel() * t.element_size()
                   for t in (getattr(self, f) for f in self.tensor_fields))

    def rows(self, tables, ids: torch.Tensor):
        """``t[ids]`` for a per-node table ``t`` of this graph (or a tuple
        of tables indexed alike, gathered with one exchange of ids)."""
        return gather_rows(self.mesh, tables, ids)


class PaddedGraph(NamedTuple):
    """Fixed-shape host (numpy) graph arrays."""

    nbr_ids: np.ndarray  # [N+2, max_deg] int32
    nbr_logits: np.ndarray  # [N+2, max_deg] float32 (-inf padding)
    degrees: np.ndarray  # [N+2] int32
    alias_prob: np.ndarray  # [N+2, max_deg] float32
    alias_idx: np.ndarray  # [N+2, max_deg] int32
    alias_primary: np.ndarray  # [(N+2)*max_deg] int32
    alias_alias: np.ndarray  # [(N+2)*max_deg] int32
    alias_prob_bits: np.ndarray  # [(N+2)*max_deg] int32 (f32 bits)
    nbr_sorted: np.ndarray  # [N+2, max_deg] int32

    @property
    def num_nodes(self) -> int:
        """Number of real nodes (excluding <pad>/<mask>)."""
        return int(self.nbr_ids.shape[0]) - NUM_SPECIAL_NODES

    @property
    def num_total(self) -> int:
        """Total rows including the two special ids."""
        return int(self.nbr_ids.shape[0])

    @property
    def max_degree(self) -> int:
        return int(self.nbr_ids.shape[1])

    def to(self, device: Union[str, torch.device]) -> DeviceGraph:
        """The sampler's view of the graph as torch tensors on ``device``.
        Ids become int64 (torch's index type)."""

        def ids(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        prob = np.ascontiguousarray(self.alias_prob_bits).view(np.float32)
        return DeviceGraph(
            nbr_ids=ids(self.nbr_ids),
            degrees=ids(self.degrees),
            alias_primary=ids(self.alias_primary),
            alias_alias=ids(self.alias_alias),
            alias_prob=torch.as_tensor(prob.copy(), device=device),
            nbr_sorted=ids(self.nbr_sorted),
        )

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            nbr_ids=np.asarray(self.nbr_ids),
            nbr_logits=np.asarray(self.nbr_logits),
            degrees=np.asarray(self.degrees),
            alias_prob=np.asarray(self.alias_prob),
            alias_idx=np.asarray(self.alias_idx),
        )

    @classmethod
    def load(cls, path: str) -> "PaddedGraph":
        with np.load(path) as data:
            nbr_ids = data["nbr_ids"]
            nbr_logits = data["nbr_logits"]
            degrees = data["degrees"]
            if "alias_prob" in data:
                alias_prob = data["alias_prob"]
                alias_idx = data["alias_idx"]
            else:  # older files: rebuild alias tables from logits
                alias_prob, alias_idx = _build_alias_tables(
                    nbr_logits, degrees
                )
        return _assemble(nbr_ids, nbr_logits, degrees, alias_prob, alias_idx)


def _assemble(nbr_ids, nbr_logits, degrees, alias_prob, alias_idx):
    primary, alias, prob_bits, nbr_sorted = _pack_alias(
        nbr_ids, alias_prob, alias_idx, degrees
    )
    return PaddedGraph(
        nbr_ids=nbr_ids,
        nbr_logits=nbr_logits,
        degrees=degrees,
        alias_prob=alias_prob,
        alias_idx=alias_idx,
        alias_primary=primary,
        alias_alias=alias,
        alias_prob_bits=prob_bits,
        nbr_sorted=nbr_sorted,
    )


def from_edges(
    num_nodes: int,
    edges: Sequence[Tuple[int, int, float]],
    max_degree: Optional[int] = None,
) -> PaddedGraph:
    """Build a PaddedGraph from undirected weighted edges.

    Edge endpoints are **zero-based** in ``[0, num_nodes)`` and are shifted
    by ``NUM_SPECIAL_NODES`` internally. Duplicate (u, v) listings
    overwrite (last weight wins) and self-loops are dropped. ``max_degree``
    optionally caps each row to its highest-weight neighbors.
    """
    adj: list[dict[int, float]] = [{} for _ in range(num_nodes)]
    for u, v, w in edges:
        if not (0 <= u < num_nodes and 0 <= v < num_nodes):
            raise ValueError(f"edge ({u},{v}) out of range [0,{num_nodes})")
        if u == v:
            continue
        adj[u][v + NUM_SPECIAL_NODES] = float(w)
        adj[v][u + NUM_SPECIAL_NODES] = float(w)
    adj_ids = [list(a.keys()) for a in adj]
    adj_ws = [list(a.values()) for a in adj]

    if max_degree is not None:
        for n in range(num_nodes):
            if len(adj_ids[n]) > max_degree:
                order = np.argsort(adj_ws[n])[::-1][:max_degree]
                adj_ids[n] = [adj_ids[n][i] for i in order]
                adj_ws[n] = [adj_ws[n][i] for i in order]

    max_deg = max((len(a) for a in adj_ids), default=0)
    max_deg = max(max_deg, 1)  # at least one slot for the sentinel edge

    n_total = num_nodes + NUM_SPECIAL_NODES
    nbr_ids = np.zeros((n_total, max_deg), dtype=np.int32)
    nbr_logits = np.full((n_total, max_deg), NEG_INF, dtype=np.float32)
    degrees = np.zeros((n_total,), dtype=np.int32)

    for n in range(num_nodes):
        row = n + NUM_SPECIAL_NODES
        deg = len(adj_ids[n])
        degrees[row] = deg
        if deg:
            nbr_ids[row, :deg] = adj_ids[n]
            nbr_logits[row, :deg] = adj_ws[n]
        else:
            # Sentinel self-edge to <pad> keeps the distribution defined.
            nbr_logits[row, 0] = 0.0

    # Special rows (<pad>, <mask>) sample <pad> with probability 1.
    nbr_logits[0, 0] = 0.0
    nbr_logits[1, 0] = 0.0

    alias_prob, alias_idx = _build_alias_tables(nbr_logits, degrees)
    return _assemble(nbr_ids, nbr_logits, degrees, alias_prob, alias_idx)


def from_networkx(graph, max_degree: Optional[int] = None) -> PaddedGraph:
    """``from_edges`` of a networkx-like graph (``nodes()`` and
    ``edges(data=True)``; networkx itself is not needed) whose nodes are a
    contiguous integer range: 0..N-1, or the reference's relabeled 2..N+1
    (reference pmgt/pmgt/trainer.py:34-43). Edge weights default to 1."""
    nodes = sorted(graph.nodes())
    n = len(nodes)
    offset = nodes[0] if nodes else 0
    if nodes != list(range(offset, offset + n)):
        raise ValueError("graph nodes must be a contiguous integer range")
    edges = [(u - offset, v - offset, data.get("weight", 1.0))
             for u, v, data in graph.edges(data=True)]
    return from_edges(n, edges, max_degree=max_degree)

def _pack_alias(
    nbr_ids: np.ndarray,
    alias_prob: np.ndarray,
    alias_idx: np.ndarray,
    degrees: np.ndarray,
) -> Tuple[np.ndarray, ...]:
    """The flat alias triple (primary id, alias id, accept-probability
    bits) per (node, slot), and the ascending padded neighbor rows."""
    n_total, max_deg = nbr_ids.shape
    if n_total * max_deg >= 2**31:
        raise ValueError(
            f"flat alias table too large for int32 indexing: "
            f"{n_total} nodes x {max_deg} max_degree >= 2**31; "
            "pass max_degree to cap the neighbor lists"
        )
    alias_node = np.take_along_axis(nbr_ids, alias_idx, axis=1)
    slot_valid = np.arange(max_deg)[None, :] < degrees[:, None]
    nbr_sorted = np.sort(
        np.where(slot_valid, nbr_ids, n_total), axis=1
    ).astype(np.int32)
    return (
        np.ascontiguousarray(nbr_ids.reshape(-1), np.int32),
        np.ascontiguousarray(alias_node.reshape(-1), np.int32),
        np.ascontiguousarray(
            alias_prob.astype(np.float32).reshape(-1).view(np.int32)
        ),
        np.ascontiguousarray(nbr_sorted, np.int32),
    )


def _build_alias_tables(
    nbr_logits: np.ndarray, degrees: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Vose's alias method per node over softmax(edge weights), by the
    native builder (``pmgt_tpu_torch/native/alias_builder.cpp``), as the
    JAX package builds them; bit-equal to ``build_alias_tables_python``."""
    from pmgt_tpu_torch.native import build_alias_tables_native

    return build_alias_tables_native(nbr_logits, degrees)


def build_alias_tables_python(
    nbr_logits: np.ndarray, degrees: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """The plain version of ``_build_alias_tables``: Vose's alias method
    per node over softmax(edge weights) in a Python loop. O(E)."""
    n, d = nbr_logits.shape
    alias_prob = np.ones((n, d), dtype=np.float32)
    alias_idx = np.zeros((n, d), dtype=np.int32)
    for row in range(n):
        deg = int(degrees[row])
        if deg <= 1:
            continue
        w = nbr_logits[row, :deg].astype(np.float64)
        p = np.exp(w - w.max())
        p /= p.sum()
        scaled = p * deg
        small = [j for j in range(deg) if scaled[j] < 1.0]
        large = [j for j in range(deg) if scaled[j] >= 1.0]
        prob = np.ones(deg)
        idx = np.zeros(deg, dtype=np.int32)
        while small and large:
            s = small.pop()
            l = large.pop()  # noqa: E741
            prob[s] = scaled[s]
            idx[s] = l
            scaled[l] = scaled[l] - (1.0 - scaled[s])
            (small if scaled[l] < 1.0 else large).append(l)
        for j in large:
            prob[j] = 1.0
        for j in small:  # numerical leftovers
            prob[j] = 1.0
        alias_prob[row, :deg] = prob
        alias_idx[row, :deg] = idx
    return alias_prob, alias_idx
