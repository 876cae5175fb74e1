"""Production scale in the port: the memory-aware refresh chunk, the
chunked context refresh against the JAX package's, the chunk agreed over
ranks, 100k-node row-sharded tables, and the data-parallel drift of the
bf16 policy against the JAX package's.

- ``effective_refresh_chunk``: the cases of tests/test_sampling.py
  restated for the port's transient (``refresh_transient_bytes``).
- ``sample_all_contexts`` honours a chunk of 16 on a 50-node graph and,
  fed the JAX sampler's per-chunk uniforms, equals the JAX package's
  ``sample_all_contexts(..., chunk=16)`` exactly; from a generator, its
  draws equal the chunk-by-chunk loop of ``sample_context`` (the default
  chunk's stream is unchanged).
- Both PMGT tasks pass their budgeted chunk (``PMGT_TORCH_HBM_BYTES``
  set; the full chunk on the CPU without it).
- Two gloo ranks with different budgets agree on the smaller chunk and
  draw identical tables; 100k nodes × (1536 + 768) features row-sharded
  over 2 ranks hold half the bytes a rank and train within rtol 2e-4 of
  replicated tables (tests/test_scale_sharded.py's configuration).
- The bf16 policy's parameters after two steps at 2 ranks against 1: the
  port's drift is at most twice the JAX package's at 2 devices against 1
  on its virtual CPU mesh.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmgt_tpu.core.config import SamplingConfig as JSamplingConfig
from pmgt_tpu.core.config import TrainArgs as JTrainArgs
from pmgt_tpu.data.synthetic import make_synthetic_dataset as j_make_synthetic_dataset
from pmgt_tpu.graph.container import from_edges as j_from_edges
from pmgt_tpu.sampling import pairs as jpairs
from pmgt_tpu.tasks.pmgt_task import PMGTTask as JPMGTTask
from pmgt_tpu_torch.core import mesh as tmesh
from pmgt_tpu_torch.core.config import SamplingConfig, TrainArgs
from pmgt_tpu_torch.core.device import MEMORY_ENV
from pmgt_tpu_torch.core.quant import table_nbytes
from pmgt_tpu_torch.data.synthetic import make_synthetic_dataset
from pmgt_tpu_torch.graph.container import NUM_SPECIAL_NODES, PaddedGraph
from pmgt_tpu_torch.sampling import pairs as tpairs
from pmgt_tpu_torch.sampling.mcn import sample_context
from pmgt_tpu_torch.tasks import pmgt_ncf_task, pmgt_task

import torch_port_ranks as ranks

TIMEOUT = 300  # s, the launch and every collective in it
HOPS = (3, 2)


def _chunk_graph(tmp_path):
    """The 50-node ring of tests/test_sampling.py, in both packages."""
    jg = j_from_edges(50, [(i, (i + 7) % 50, 1.0) for i in range(50)])
    path = str(tmp_path / "g.npz")
    jg.save(path)
    return jg, PaddedGraph.load(path).to("cpu")


def _cfgs(n_total):
    kw = dict(max_ctx_neigh=3, hop_sampling_sizes=HOPS, max_total_samples=4,
              min_neg_samples=2, num_total=n_total)
    return JSamplingConfig(**kw), SamplingConfig(**kw)


# ----------------------------------------------------------------------
# effective_refresh_chunk
# ----------------------------------------------------------------------

def test_refresh_transient_counts_the_samplers_live_set():
    """95 bytes a draw of every hop and 4 a last-hop draw, a node: 64,368
    at hops 16/8/4 (T = 656, L = 512)."""
    cfg = SamplingConfig()
    assert tpairs.refresh_transient_bytes(cfg, 1) == 95 * 656 + 4 * 512 == 64_368
    assert tpairs.refresh_transient_bytes(cfg, 65_536) == 65_536 * 64_368
    assert tpairs.refresh_transient_bytes(SamplingConfig(hop_sampling_sizes=(3,)), 10) == 2_970


@pytest.mark.parametrize("hops", [(16, 8, 4), (8, 4, 2)])
def test_effective_refresh_chunk_memory_pressure(tmp_path, hops):
    """No budget: the full chunk. Room for two full-chunk transients: the
    full chunk; for two quarter-chunk ones: a quarter; none: the floor."""
    _, g = _chunk_graph(tmp_path)
    cfg = SamplingConfig(hop_sampling_sizes=hops)
    full = 2 * tpairs.refresh_transient_bytes(cfg, tpairs.REFRESH_CHUNK)
    assert tpairs.effective_refresh_chunk(g, cfg) == tpairs.REFRESH_CHUNK == 65_536
    assert tpairs.effective_refresh_chunk(g, cfg, full) == 65_536
    assert tpairs.effective_refresh_chunk(g, cfg, full - 1) == 32_768
    assert tpairs.effective_refresh_chunk(g, cfg, full // 4) == 16_384
    assert tpairs.effective_refresh_chunk(g, cfg, 0) == tpairs.MIN_REFRESH_CHUNK == 8_192


# ----------------------------------------------------------------------
# the chunked refresh
# ----------------------------------------------------------------------

def _jax_hop_uniforms(key, batch, hops):
    hop_keys = jax.random.split(key, len(hops))
    draws, f = [], 1
    for k, num in enumerate(hops):
        draws.append(np.array(jax.random.uniform(hop_keys[k], (batch, f, num))))
        f *= num
    return draws


def test_sample_all_contexts_honours_a_small_chunk_exactly_as_jax(tmp_path):
    """Chunks of 16 over 52 rows (4 chunks, the last of 4 rows). Fed each
    chunk's uniforms as the JAX sampler draws them (``split(key, 4)[i]``
    over the padded chunk of 16; the real rows' slices), the port's table
    equals the JAX package's exactly."""
    jg, g = _chunk_graph(tmp_path)
    n = g.num_total
    jcfg, cfg = _cfgs(n)
    key = jax.random.key(0)
    want_ids, want_mask = jpairs.sample_all_contexts(jg, key, jcfg, n, chunk=16)
    keys = jax.random.split(key, -(-n // 16))
    draws = [[u[: min(16, n - 16 * i)] for u in _jax_hop_uniforms(k, 16, HOPS)]
             for i, k in enumerate(keys)]
    ids, mask = tpairs.sample_all_contexts(g, cfg, n, chunk=16, draws=draws)
    assert ids.shape == mask.shape == (n, cfg.seq_len)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    assert (mask[:NUM_SPECIAL_NODES, 1:] == 0).all()
    assert (ids[NUM_SPECIAL_NODES:, 0].numpy() == np.arange(NUM_SPECIAL_NODES, n)).all()


@pytest.mark.parametrize("chunk", [tpairs.REFRESH_CHUNK, 16, 7])
def test_generator_draws_are_the_chunk_loop(tmp_path, chunk):
    """From a generator the table is ``sample_context`` over the chunks in
    order, the special rows cleared: at the default chunk one call over
    every row, as before the chunk was budgeted."""
    _, g = _chunk_graph(tmp_path)
    n = g.num_total
    _, cfg = _cfgs(n)
    gen = torch.Generator().manual_seed(11)
    ref = [sample_context(g, torch.arange(n)[s: s + chunk], cfg, gen)
           for s in range(0, n, chunk)]
    want_ids = torch.cat([r[0] for r in ref])
    want_mask = torch.cat([r[1] for r in ref])
    want_ids[:NUM_SPECIAL_NODES, 1:] = 0
    want_mask[:NUM_SPECIAL_NODES, 1:] = 0.0
    kw = {} if chunk == tpairs.REFRESH_CHUNK else {"chunk": chunk}
    ids, mask = tpairs.sample_all_contexts(g, cfg, n, torch.Generator().manual_seed(11), **kw)
    assert torch.equal(ids, want_ids) and torch.equal(mask, want_mask)


@pytest.mark.parametrize("chunk", [0, -3])
def test_sample_all_contexts_rejects_a_chunk_below_one(tmp_path, chunk):
    _, g = _chunk_graph(tmp_path)
    _, cfg = _cfgs(g.num_total)
    with pytest.raises(ValueError, match="at least 1"):
        tpairs.sample_all_contexts(g, cfg, g.num_total, torch.Generator(), chunk=chunk)


# ----------------------------------------------------------------------
# the tasks' budget
# ----------------------------------------------------------------------

def _pmgt_ncf_task():
    args = TrainArgs(model_name="NeuMF-end", dataset_name="syn", seed=0, num_epochs=1,
                     train_batch_size=16, test_batch_size=64, early_criterion="n20",
                     extra=dict(ranks.EXTRA))
    ctx = {"artifacts": make_synthetic_dataset(**ranks.DATA), "device": "cpu"}
    pmgt_ncf_task.init_dataloader(args, ctx)
    pmgt_ncf_task.init_model(args, ctx)
    return ctx["task"]


@pytest.mark.parametrize("kind", ["pmgt", "pmgt_ncf"])
def test_tasks_pass_the_budgeted_chunk(monkeypatch, kind):
    """Without ``PMGT_TORCH_HBM_BYTES`` the CPU has no budget: the full
    chunk. With it, the budget is the override less 3 GiB, the tables,
    the graph and the resident draws, and the refresh draws in the chunk
    it gives (a quarter of the full one here)."""
    build = ranks.small_task if kind == "pmgt" else _pmgt_ncf_task
    module = pmgt_task if kind == "pmgt" else pmgt_ncf_task
    monkeypatch.delenv(MEMORY_ENV, raising=False)
    task = build()
    seq, pairs = task.sampling.seq_len, task.sampling.max_total_samples
    n = task.sampling.num_total
    cached = n * (5 * 12 * seq + 16 * (pairs + 4)) if kind == "pmgt" else n * 3 * 12 * seq
    persistent = sum(table_nbytes(t) for t in task.feat_tables) + task.graph.nbytes
    assert task.refresh == {
        "capacity_bytes": None, "persistent_bytes": persistent, "cached_bytes": cached,
        "free_bytes": None, "chunk": 65_536,
        "transient_bytes": tpairs.refresh_transient_bytes(task.sampling, 65_536)}

    free = 3 * tpairs.refresh_transient_bytes(task.sampling, 16_384)
    monkeypatch.setenv(MEMORY_ENV, str(pmgt_task.REFRESH_HEADROOM + persistent + cached + free))
    chunks = []
    real = module.sample_all_contexts

    def spy(*a, **k):
        chunks.append(k["chunk"])
        return real(*a, **k)

    monkeypatch.setattr(module, "sample_all_contexts", spy)
    task = build()
    assert task.refresh["free_bytes"] == free and task.refresh["chunk"] == 16_384
    if kind == "pmgt":
        task.train_epoch(0)
        task.evaluate("valid")
    else:
        task.on_epoch_start(0)
        task.eval_ctx()
    assert chunks == [16_384, 16_384]
    monkeypatch.setenv(MEMORY_ENV, "0")
    assert build().refresh["chunk"] == 8_192


# ----------------------------------------------------------------------
# two gloo ranks: the agreed chunk, 100k-node sharded tables, the drift
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_ranks():
    """Rank 0 budgets no memory at all (the floor), rank 1 has no budget."""
    return tmesh.launch(ranks.scale_checks, 2, ([0, None],), device="cpu", timeout_s=TIMEOUT,
                        run_timeout_s=TIMEOUT, num_threads=1)


def test_ranks_agree_on_the_smaller_chunk(two_ranks):
    assert [r["own_chunk"] for r in two_ranks] == [8_192, 65_536]
    assert [r["refresh"]["chunk"] for r in two_ranks] == [8_192, 8_192]
    one = ranks.small_task()
    want = one._get_ctx(("train", 0))
    for r in two_ranks:
        assert torch.equal(r["train_ctx"][0], want[0])
        assert torch.equal(r["train_ctx"][1], want[1])


def test_sharded_tables_100k_footprint_and_parity(two_ranks):
    """Each rank holds half the bf16 feature tables (100,002 rows: 50,001
    a rank); the two-step losses equal across ranks and within rtol 2e-4
    of replicated tables."""
    n_rows = ranks.SCALE_DATA["num_nodes"] + NUM_SPECIAL_NODES
    total = n_rows * sum(ranks.SCALE_DATA["feat_dims"]) * 2  # bf16
    for r in two_ranks:
        assert r["fusion"] == "gather_rows"
        assert r["feat_rows_rank"] == [n_rows // 2, n_rows // 2]
        assert r["feat_rank_bytes"] * 2 == total
        assert all(np.isfinite(r["sharded_losses"]))
        np.testing.assert_allclose(r["sharded_losses"], r["replicated_losses"], rtol=2e-4)
    assert two_ranks[0]["sharded_losses"] == two_ranks[1]["sharded_losses"]


def _jax_drift_params(num_devices):
    art = j_make_synthetic_dataset(**ranks.DATA)
    args = JTrainArgs(model_name="PMGT", dataset_name="syn", seed=0, num_epochs=1,
                      train_batch_size=16, test_batch_size=16, num_devices=num_devices,
                      extra=dict(ranks.EXTRA), **ranks.DRIFT_KW)
    nodes = np.arange(2, 42, dtype=np.int32)
    task = JPMGTTask(args, art, nodes[:32], nodes[32:])
    state = task.state
    for batch in task.train_batches(0):
        state, _ = task.train_step(state, batch)
    return [np.asarray(x, np.float64) for x in jax.tree.leaves(state.params)]


def test_data_parallel_drift_is_no_worse_than_the_jax_packages(two_ranks):
    """Two steps of the bf16 policy (lr 1e-3) at 2 ranks against 1: the
    largest parameter difference in the port is at most twice the JAX
    package's at 2 devices against 1 (the same configuration on its
    virtual CPU mesh). The 1-rank run takes one thread, as each rank."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = ranks.drift_params()
    finally:
        torch.set_num_threads(threads)
    port = max(float((two_ranks[0]["drift_params"][k].double() - v.double()).abs().max())
               for k, v in one.items())
    for r in two_ranks[1:]:
        assert all(torch.equal(r["drift_params"][k], two_ranks[0]["drift_params"][k])
                   for k in one)
    j1, j2 = _jax_drift_params(1), _jax_drift_params(2)
    jax_drift = max(float(np.abs(a - b).max()) for a, b in zip(j1, j2))
    assert len(j1) == len(one)
    assert port <= 2 * jax_drift, (port, jax_drift)


# ----------------------------------------------------------------------
# the scale smoke and the profiler's guard
# ----------------------------------------------------------------------

def test_scale_smoke_runs_through_the_task(capsys):
    """``python -m pmgt_tpu_torch.tools.scale_smoke`` on the CPU at 3,000
    nodes: one JSON line a result, the epochs through ``train_epoch``."""
    from pmgt_tpu_torch.tools import scale_smoke

    assert scale_smoke.main(["--device", "cpu", "--num-nodes", "3000", "--batch", "64",
                             "--epochs", "1", "--steps", "2"]) == 0
    import json

    rows = {r["phase"]: r for r in map(json.loads, capsys.readouterr().out.splitlines())}
    assert list(rows) == ["scale_setup", "scale_refresh_budget", "scale_epoch0", "scale_epoch1",
                          "scale_result"]
    setup = rows["scale_setup"]
    assert setup["num_nodes"] == 3000 and setup["fusion"] == "project_tables"
    assert setup["feat_total"] == setup["feat_rank"] == 3002 * (1536 + 768) * 2  # bf16
    assert rows["scale_refresh_budget"]["chunk"] == 65_536
    assert rows["scale_refresh_budget"]["chunk_transient"]["formula_bytes"] == 3002 * 64_368
    for e in ("scale_epoch0", "scale_epoch1"):
        assert rows[e]["steps"] == 2 and rows[e]["losses_finite"]
    assert np.isfinite(rows["scale_result"]["val/auc"])


def test_a_card_session_without_device_events_raises(tmp_path):
    """``--profile-dir`` on a card: a session that ran to its end but saw
    no device event raises and writes no trace; a session whose work
    raised still writes its trace, and the work's error comes through."""
    from pmgt_tpu_torch.cli.main import _profiled

    with pytest.warns(UserWarning), pytest.raises(RuntimeError, match="no device event"):
        _profiled(lambda: torch.ones(3).sum(), str(tmp_path / "a"), "cuda")
    assert not (tmp_path / "a").exists() or not list((tmp_path / "a").iterdir())
    with pytest.warns(UserWarning), pytest.raises(ZeroDivisionError):
        _profiled(lambda: 1 / 0, str(tmp_path / "b"), "cuda")
    assert any(p.name.endswith(".pt.trace.json") for p in (tmp_path / "b").iterdir())
    _profiled(lambda: torch.ones(3).sum(), str(tmp_path / "c"), "cpu")
    assert any(p.name.endswith(".pt.trace.json") for p in (tmp_path / "c").iterdir())


def test_synthetic_features_drawn_in_row_blocks_equal_the_jax_packages(monkeypatch):
    """The port draws the feature noise in row blocks (the host holds one
    block of float64 draws); at blocks of 7 rows its tables are still the
    JAX package's bit for bit."""
    from pmgt_tpu_torch.data import synthetic

    monkeypatch.setattr(synthetic, "_NOISE_ROWS", 7)
    kw = dict(num_nodes=300, num_users=20, feat_dims=(12, 5), avg_degree=6, seed=3)
    mine, theirs = synthetic.make_synthetic_dataset(**kw), j_make_synthetic_dataset(**kw)
    for a, b in zip(mine.feat_init_embs, theirs.feat_init_embs):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(mine.train_pairs, np.asarray(theirs.train_pairs))
