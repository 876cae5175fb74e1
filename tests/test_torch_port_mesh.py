"""``pmgt_tpu_torch/core/mesh.py`` in one process, against the JAX package's
``core/mesh.py`` on the suite's 8-device CPU mesh.

- ``shard_rows`` and ``place_graph`` give rank r exactly the rows JAX's
  ``shard_rows_host`` / ``place_graph`` put on device r
  (``addressable_shards[r].data``): 42 rows padded to 48; ``degrees``
  whole at max_deg 1; the flat ``[(N+2)·max_deg]`` tables padded so each
  device's chunk is a multiple of max_deg. ``prepare_feat_tables(...,
  shard=)`` shards int8 codes and scales as JAX's does.
- ``ShardedDraws`` / ``lane_draws``: a rank's draws are its lanes of the
  global draw (uniforms, integers, lane groups).
- Without a process group every collective is the identity and
  ``make_mesh`` raises when more devices are asked for than there are.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from pmgt_tpu.core import mesh as jmesh
from pmgt_tpu.core import quant as jquant
from pmgt_tpu.graph import container as jcontainer
from pmgt_tpu_torch.core import mesh as tmesh
from pmgt_tpu_torch.core.quant import QuantizedTable, ShardedTable, prepare_feat_tables
from pmgt_tpu_torch.graph import container as tcontainer

# The port's device-graph fields and the JAX graph fields they hold.
GRAPH_FIELDS = {"nbr_ids": "nbr_ids", "degrees": "degrees", "nbr_sorted": "nbr_sorted",
                "alias_primary": "alias_primary", "alias_alias": "alias_alias",
                "alias_prob": "alias_prob_bits"}


def _rank(r, size=8):
    return tmesh.Mesh(size=size, rank=r)


def _shards(x):
    """A JAX array's per-device data, in device order."""
    return [np.asarray(s.data) for s in sorted(x.addressable_shards, key=lambda s: s.device.id)]


def _edges(kind):
    if kind == "synthetic":  # the 40-node graph of tests/test_sharding.py
        rs = np.random.RandomState(0)
        return 40, [(int(u), int(v), float(rs.uniform(0.5, 2)))
                    for u, v in rs.randint(0, 40, (120, 2)) if u != v], None
    if kind == "chain":  # max_deg 1: degrees has a flat table's shape
        return 9, [(i, i + 1, 1.0) for i in range(8)], 1
    # degree 70 > 64: the JAX graph builds its flat draw tables
    return 92, [(i, j, 1.0 + (i * j) % 7) for i in range(92) for j in range(i + 1, min(i + 70, 92))], None


def test_make_mesh_without_a_group():
    mesh = tmesh.make_mesh(None, "cpu")
    assert (mesh.size, mesh.rank, mesh.distributed, mesh.is_primary) == (1, 0, False, True)
    assert tmesh.make_mesh(1, "cpu") == mesh
    with pytest.raises(ValueError, match="requested 2 devices but only 1 are visible"):
        tmesh.make_mesh(2, "cpu")
    with pytest.raises(ValueError):
        jmesh.make_mesh(99)  # the JAX package refuses alike


@pytest.mark.parametrize("rows,cols", [(42, 3), (48, 2), (5, 1), (42, 0)])
def test_shard_rows_matches_jax(rows, cols):
    a = np.arange(rows * max(cols, 1), dtype=np.float32).reshape((rows, cols) if cols else (rows,))
    want = _shards(jmesh.shard_rows_host(jmesh.make_mesh(8), a))
    for r in range(8):
        got = tmesh.shard_rows(_rank(r), a)
        np.testing.assert_array_equal(got, want[r])
        np.testing.assert_array_equal(tmesh.shard_rows(_rank(r), torch.from_numpy(a)).numpy(),
                                      want[r])
    assert sum(len(w) for w in want) == -(-rows // 8) * 8


@pytest.mark.parametrize("kind", ["synthetic", "chain", "flat"])
def test_place_graph_matches_jax(kind):
    n, edges, cap = _edges(kind)
    jg = jcontainer.from_edges(n, edges, max_degree=cap)
    tg = tcontainer.from_edges(n, edges, max_degree=cap)
    placed = jmesh.place_graph(jmesh.make_mesh(8), jg.runtime_view(), shard=True)
    checked = 0
    for r in range(8):
        mine = tmesh.place_graph(_rank(r), tg, shard=True, device="cpu")
        assert mine.num_total == n + 2 and mine.max_degree == tg.max_degree
        for port_name, jax_name in GRAPH_FIELDS.items():
            jx = getattr(placed, jax_name)
            if jx.shape[0] <= 1:
                continue  # a placeholder: this JAX graph draws from its row tables
            got = getattr(mine, port_name)
            if port_name == "alias_prob":
                got = got.view(torch.int32)
            want = np.asarray(jx) if port_name == "degrees" else _shards(jx)[r]
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{port_name} rank {r}")
            checked += 1
    assert placed.degrees.sharding.is_fully_replicated
    if kind == "flat":
        md = tg.max_degree
        assert md > jcontainer.ROW_DRAW_MAX_DEG and checked == 8 * 6
        assert tmesh.place_graph(_rank(0), tg, True, "cpu").alias_primary.shape[0] % md == 0
    if kind == "synthetic":
        assert tmesh.place_graph(_rank(3), tg, True, "cpu").nbr_ids.shape[0] == 6  # 42 -> 48


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_sharded_feat_tables_match_jax(dtype):
    rs = np.random.default_rng(0)
    tables = [rs.standard_normal((42, 12)).astype(np.float32),
              rs.standard_normal((42, 8)).astype(np.float32)]
    want = jquant.prepare_feat_tables(tables, dtype, jmesh.make_mesh(8), shard=True)
    for r in range(8):
        got = prepare_feat_tables(tables, dtype, "cpu", shard=_rank(r))
        for g, w in zip(got, want):
            assert isinstance(g, ShardedTable) and g.shape == (42, w.shape[1] if dtype != "int8"
                                                                else w.q.shape[1])
            if dtype == "int8":
                assert isinstance(g.local, QuantizedTable)
                np.testing.assert_array_equal(g.local.q.numpy(), _shards(w.q)[r])
                np.testing.assert_array_equal(g.local.scale.numpy(), _shards(w.scale)[r])
            else:
                np.testing.assert_array_equal(g.local.numpy(), _shards(w)[r])


def test_sharded_draws_keep_the_ranks_lanes():
    index = torch.tensor([2, 3, 7])
    gen = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    full = torch.rand((4, 8, 6), generator=gen())
    got = tmesh.rand((4, 3, 6), tmesh.ShardedDraws(gen(), index, 8), axis=1)
    assert torch.equal(got, full[:, index])
    grouped = tmesh.rand((6, 2), tmesh.ShardedDraws(gen(), torch.tensor([1, 2, 3]), 4),
                         axis=0, group=2)
    assert torch.equal(grouped, torch.rand((8, 2), generator=gen())[2:8])
    ints = tmesh.randint(2, 50, (3, 5), tmesh.ShardedDraws(gen(), index, 8))
    assert torch.equal(ints, torch.randint(2, 50, (8, 5), generator=gen())[index])
    with pytest.raises(ValueError, match="lanes"):
        tmesh.rand((4, 4, 6), tmesh.ShardedDraws(gen(), index, 8), axis=1)
    draws = tmesh.ShardedDraws(gen(), index, 8)
    state = draws.get_state()
    a = tmesh.rand((3,), draws)
    assert torch.equal(tmesh.rand((3,), draws.restored(state)), a)


def test_lane_draws_lay_out_the_three_segments():
    """[targets | pairs | masked] at 2 ranks of 2 targets with 3 pairs each
    (4 + 12 + 4 lanes): rank 1 keeps lanes 2-3, 4+6..4+11 and 16+2..16+3."""
    mesh = tmesh.Mesh(size=2, rank=1)
    draws = tmesh.lane_draws(mesh, torch.Generator(), [(4, 2), (12, 6), (4, 2)])
    assert draws.total == 20
    assert draws.index.tolist() == [2, 3, 4 + 6, 4 + 7, 4 + 8, 4 + 9, 4 + 10, 4 + 11, 18, 19]
    g = torch.Generator()
    assert tmesh.lane_draws(tmesh.Mesh(), g, [(4, 4)]) is g


def test_collectives_are_identities_without_a_group():
    mesh = tmesh.Mesh()
    x = torch.arange(6.0).reshape(3, 2)
    assert tmesh.all_reduce(mesh, x) is x
    assert tmesh.gather_to_host(mesh, x) is x
    assert torch.equal(tmesh.gather_chunks(mesh, x.reshape(3, 1, 2)), x)
    assert tmesh.any_rank(mesh, True) and not tmesh.any_rank(mesh, False)
    assert tmesh.broadcast_object(mesh, {"a": 1}) == {"a": 1}
    tmesh.barrier(mesh)
    table = torch.arange(20.0).reshape(10, 2)
    ids = torch.tensor([[3, 1], [9, 9]])
    assert torch.equal(tmesh.gather_rows(mesh, table, ids), table[ids])
    a, b = tmesh.gather_rows(mesh, (table, table[:, :1]), ids)
    assert torch.equal(a, table[ids]) and torch.equal(b, table[ids, :1])


def test_local_slices_and_padding():
    mesh = tmesh.Mesh(size=4, rank=2)
    assert tmesh.local_slice(mesh, 16) == slice(8, 12)
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.local_slice(mesh, 10)
    assert [tmesh.pad_to_multiple(n, 4) for n in (1, 4, 5)] == [4, 4, 8]
    assert tmesh.pad_to_multiple(256, 8) == jmesh.pad_to_multiple(256, 8)


def test_backend_and_devices():
    assert tmesh.resolve_backend("cpu", 4) == "gloo"
    with pytest.raises(ValueError, match="nccl"):
        tmesh.resolve_backend("cpu", 1, "nccl")
    assert tmesh.rank_device("cpu", 3) == torch.device("cpu")
    assert tmesh.distributed_trio() is None
    assert tmesh.distributed_trio("h:1", 2, 1) == ("h:1", 2, 1)
    with pytest.raises(ValueError, match="--num-processes"):
        tmesh.distributed_trio("h:1")


def test_jax_environment_trio(monkeypatch):
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.1:1234")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
    monkeypatch.setenv("JAX_PROCESS_ID", "3")
    assert tmesh.distributed_trio() == ("10.0.0.1:1234", 4, 3)
    assert len(jax.devices()) == 8  # the JAX side of the suite is untouched
