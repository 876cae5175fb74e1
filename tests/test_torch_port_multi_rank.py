"""Data parallelism of the port on the CPU: gloo ranks that
``core.mesh.launch`` spawns (one torch thread each, every launch under its
own timeout), against the port's own 1-rank run and against the JAX
package on its 8-device mesh.

- 2 ranks against 1, one epoch of the small config of
  ``tests/test_sharding.py``: losses rtol 2e-4, parameters rtol 5e-4 /
  atol 1e-5 and bit-equal across the ranks, AUC within 2e-4, export within
  1e-5; also with ``accumulation_step`` 2 and without the context cache.
- Row-sharded feature and graph tables against replicated tables at 2 and
  4 ranks, both fusion strategies and int8 tables: losses rtol 2e-4, AUC
  within 2e-4, ``num_total`` 42 (the blocks hold 42 rows padded to a
  multiple of the ranks), and the contexts bit-equal to the replicated
  draw.
- Evaluation and export of JAX parameters (``params_from_flax``) over the
  JAX task's own phase tables at 2 ranks: AUC and export within 1e-5 of
  the JAX package on its 8-device mesh.
- The engine at 2 ranks: one run directory written once (rank 0 only) and
  one run id on both ranks; a SIGTERM to rank 1 alone stops both after
  the same epoch (INTERRUPTED); the resume reproduces the uninterrupted
  run's metrics; the export is written by rank 0 alone; a barrier that a
  rank never reaches raises.
- ``launch``: ranks idle for longer than the collective timeout finish;
  a deadline given for the run stops them.
- Two processes started with the multi-host trio, as
  ``tests/test_multihost.py`` starts the JAX package's, print identical
  results.
"""
from __future__ import annotations

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from pmgt_tpu.core.config import TrainArgs as JTrainArgs
from pmgt_tpu.data import synthetic as jsynthetic
from pmgt_tpu.tasks import pmgt_task as jtask_mod
from pmgt_tpu_torch.cli.main import main
from pmgt_tpu_torch.core import mesh as tmesh
from pmgt_tpu_torch.models.interop import params_from_flax
from pmgt_tpu_torch.train.registry import RunRegistry

import torch_port_ranks as ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300  # s, every launch and every collective in it

REPLICATED = {"replicated": ({}, {}), "accumulation": ({}, {"accumulation_step": 2}),
              "no_ctx_cache": ({"ctx_cache": False}, {})}
SHARD = {"shard_feat_tables": True, "shard_graph_tables": True}
SHARDED = {"gather_rows": {"fusion_strategy": "gather_rows"},
           "project_tables": {"fusion_strategy": "project_tables"},
           "int8": {"fusion_strategy": "gather_rows", "feat_tables_dtype": "int8"}}
JAX_DATA = dict(num_nodes=150, num_users=40, feat_dims=(64, 32), avg_degree=6,
                interactions_per_user=3, seed=0)
JAX_EXTRA = dict(hidden_size=32, intermediate_size=32, num_hidden_layers=2)


def _launch(fn, n, *args, timeout=TIMEOUT):
    return tmesh.launch(fn, n, args, device="cpu", timeout_s=timeout, run_timeout_s=timeout,
                        num_threads=1)


@pytest.fixture(scope="module")
def jax_eval():
    """The JAX task on its 8-device mesh: its parameters as the port's state
    dict, its valid and inference phase tables, its AUC and export."""
    art = jsynthetic.make_synthetic_dataset(**JAX_DATA)
    args = JTrainArgs(seed=3, test_batch_size=32, train_batch_size=16, extra=dict(JAX_EXTRA))
    ctx = {"artifacts": art}
    jtask_mod.init_dataloader(args, ctx)
    task = jtask_mod.PMGTTask(args, art, ctx["train_nodes"], ctx["valid_nodes"])
    assert task.mesh.size == 8
    tables = {}
    for tag in (("valid",), ("inference",)):
        ids, mask, pairs = task._get_ctx(tag)
        tables[tag] = (np.array(ids), np.array(mask),
                       None if pairs is None else tuple(np.array(p) for p in pairs))
    return {"state": params_from_flax(task.state.params), "tables": tables,
            "auc": task.evaluate(task.state, "valid")["val/auc"],
            "emb": task.export_embeddings(task.state.params)}


@pytest.fixture(scope="module")
def two_ranks(jax_eval):
    """One 2-rank launch: the replicated and sharded configurations, then
    the evaluation of the JAX parameters."""
    configs = {**REPLICATED, **{k: ({**v, **SHARD}, {}) for k, v in SHARDED.items()}}
    given = (dict(seed=3, test_batch_size=32, extra=dict(JAX_EXTRA)), JAX_DATA,
             jax_eval["state"], jax_eval["tables"])
    return _launch(ranks.pmgt_epochs, 2, configs, given)


@pytest.fixture(scope="module")
def four_ranks():
    return _launch(ranks.pmgt_epochs, 4, {k: ({**v, **SHARD}, {}) for k, v in SHARDED.items()})


def _reference(name):
    extra, kw = {**REPLICATED, **{k: (v, {}) for k, v in SHARDED.items()}}[name]
    return ranks.pmgt_epoch(extra, kw)


@pytest.mark.parametrize("name", sorted(REPLICATED))
def test_two_ranks_match_one_rank(two_ranks, name):
    ref = _reference(name)
    for got in two_ranks:
        np.testing.assert_allclose(got[name]["losses"], ref["losses"], rtol=2e-4)
        for k, want in ref["params"].items():
            np.testing.assert_allclose(got[name]["params"][k].numpy(), want.numpy(), rtol=5e-4,
                                       atol=1e-5, err_msg=k)
        assert abs(got[name]["metrics"]["val/auc"] - ref["metrics"]["val/auc"]) <= 2e-4
        np.testing.assert_allclose(got[name]["emb"], ref["emb"], atol=1e-5)
    for k in ref["params"]:  # every rank applied the same updates
        assert torch.equal(two_ranks[0][name]["params"][k], two_ranks[1][name]["params"][k]), k


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", sorted(SHARDED))
def test_sharded_tables_match_replicated(two_ranks, four_ranks, world, name):
    ref = _reference(name)  # one process: the tables whole
    runs = two_ranks if world == 2 else four_ranks
    assert [r[name]["rank"] for r in runs] == list(range(world))
    for got in runs:
        run = got[name]
        np.testing.assert_allclose(run["losses"], ref["losses"], rtol=2e-4)
        assert abs(run["metrics"]["val/auc"] - ref["metrics"]["val/auc"]) <= 2e-4
        assert run["num_total"] == 42  # the true node count, not the padded rows
        block = -(-42 // world)
        assert run["graph_rows"] == block and run["table_rows"] == [block, block]
        for a, b in zip(run["train_ctx"][:2], ref["train_ctx"][:2]):
            assert torch.equal(a, b)  # the replicated draw, bit for bit
        for a, b in zip(run["train_ctx"][2], ref["train_ctx"][2]):
            assert torch.equal(a, b)
        for a, b in zip(run["valid_ctx"][:2], ref["valid_ctx"][:2]):
            assert torch.equal(a, b)


def test_jax_parameters_evaluate_and_export_as_on_the_jax_mesh(two_ranks, jax_eval):
    for got in two_ranks:
        assert abs(got["jax_params"]["metrics"]["val/auc"] - jax_eval["auc"]) <= 1e-5
        np.testing.assert_allclose(got["jax_params"]["emb"], jax_eval["emb"], atol=1e-5)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    main(["make-synthetic", "--out-dir", str(d / "synth"), "--num-nodes", "150",
          "--num-users", "40", "--visual-dim", "64", "--textual-dim", "32",
          "--avg-degree", "6"])
    return str(d)


@pytest.fixture(scope="module")
def engine(data_dir, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("engine"))
    return root, _launch(ranks.engine_flows, 2, data_dir, root)


def test_engine_writes_once_with_one_run_id(engine):
    root, runs = engine
    for name in ("full", "resumed"):
        (run,) = RunRegistry(os.path.join(root, name)).list_runs()  # one run directory
        assert run.status == "FINISHED"
        aucs = [m["epoch"] for m in run.metrics() if m["name"] == "val/auc"]
        assert aucs == [0, 1, 2, 3]  # each epoch logged once: rank 1 wrote nothing
    assert runs[0]["run_id"] == runs[1]["run_id"]


def test_sigterm_to_one_rank_stops_both_after_the_same_epoch(engine):
    _, runs = engine
    for got in runs:
        assert got["status_after_signal"] == "INTERRUPTED"
        assert got["epochs_after_signal"] == [0, 1]


def test_resume_reproduces_the_uninterrupted_run(engine):
    root, runs = engine
    (full,) = RunRegistry(os.path.join(root, "full")).list_runs()
    (resumed,) = RunRegistry(os.path.join(root, "resumed")).list_runs()
    rows = lambda run: sorted((m["epoch"], m["name"], m["value"]) for m in run.metrics()  # noqa: E731
                              if m["name"] in ("val/auc", "val/loss", "loss/train"))
    assert rows(resumed) == rows(full)
    for got in runs:
        assert got["resumed"] == got["full"] == runs[0]["full"]


def test_inference_writes_once(engine):
    root, runs = engine
    assert [r["saves"] for r in runs] == [1, 0]  # rank 0 alone wrote the export
    written = np.load(os.path.join(root, "emb.npy"))
    for got in runs:  # every rank holds the gathered export
        np.testing.assert_array_equal(got["export"], written)


@pytest.mark.parametrize("run_timeout", [None, 4.0])
def test_a_run_outlasts_the_collective_timeout_unless_given_a_deadline(run_timeout):
    """The collective timeout bounds each collective, not the run: ranks
    idle for longer than it, with no collective pending, still finish.
    Only a deadline given for the run stops them."""
    def call():
        return tmesh.launch(ranks.sleep_then_barrier, 2, (12.0,), device="cpu", timeout_s=10,
                            run_timeout_s=run_timeout, num_threads=1)

    if run_timeout is None:
        assert call() == [12.0, 12.0]
    else:
        with pytest.raises(TimeoutError, match="did not finish"):
            call()


def test_a_failed_barrier_raises():
    got = _launch(ranks.barrier_flow, 2, timeout=60)
    assert got[0].startswith("raised") and got[1] == "left", got


def _free_port() -> int:
    return tmesh.free_port()


def test_two_processes_started_with_the_trio_print_identical_results(data_dir, tmp_path):
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "pmgt_tpu_torch.cli.main", "--device", "cpu", "train-pmgt",
           "--model-name", "pmgt", "--dataset-name", "synth", "--data-dir", data_dir,
           "--log-dir", str(tmp_path / "logs"), "--num-epochs", "1", "--train-batch-size", "16",
           "--test-batch-size", "32", "--hidden-size", "16", "--intermediate-size", "16",
           "--num-hidden-layers", "1", "--early-criterion", "auc",
           "--coordinator-address", f"127.0.0.1:{port}", "--num-processes", "2"]
    procs = [subprocess.Popen([*cmd, "--process-id", str(i)], cwd=ROOT, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for i in (0, 1)]
    lines = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=TIMEOUT)
        finally:
            p.kill()
        assert p.returncode == 0, err[-3000:]
        lines.append(re.sub(r"^\S+ \S+ ", "", next(
            line for line in err.splitlines() if "test results" in line)))
    assert lines[0] == lines[1], lines
    (run,) = RunRegistry(str(tmp_path / "logs")).list_runs()
    assert run.status == "FINISHED"
