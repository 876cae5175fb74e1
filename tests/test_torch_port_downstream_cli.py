"""The port's downstream commands (``train-ncf``, ``train-dcn``,
``train-pmgt-ncf``) against the JAX package's click commands, and the
downstream pipeline end to end on the CPU.

- ``--save-args`` writes the JAX CLI's JSON for the same argv (defaults,
  options set, options not ported yet), and each package loads the other's
  file.
- ``make-synthetic`` → ``train-pmgt`` → ``--mode inference`` export →
  ``train-ncf --model-name NeuMF-end --item-init-emb-path`` (the MLP item
  table starts as the export, and the JAX package's NCF task builds the
  same table from the same file) → ``--mode eval`` → ``--mode inference``
  (an ``.npz`` of user_ids/item_ids/scores, no training positive served).
- NeuMF-pre from a GMF run and an MLP run: its initial parameters are
  ``fuse_neumf_params`` of the two runs' ``best`` checkpoints.
- ``train-dcn`` (with the export, ``--freeze-item-init-emb``) and
  ``train-pmgt-ncf`` in train, eval and inference modes.
- Status rules: a run that fails while training is FAILED; eval and
  inference against an existing run leave its status as it was.
- The multi-GPU options run: each command at two gloo ranks on the CPU
  gives the 1-rank run's test metrics (losses rtol 2e-4, ranking metrics
  and AUC equal), PMGT_NCF with both shard flags; the options the commands
  refused before
  (``--mp-enabled``, ``--profile-dir``, ``--feat-tables-dtype``) run, and
  ``--mp-enabled`` leaves NCF and DCN exactly as they are without it; the
  default device is the card, so without one a run refuses to start.
- The new modules import with JAX, flax, optax, orbax, click, sklearn and
  ``pmgt_tpu`` unavailable.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from pmgt_tpu.cli.main import cli as jax_cli
from pmgt_tpu.core.config import TrainArgs as JTrainArgs
from pmgt_tpu_torch.cli.main import main
from pmgt_tpu_torch.core.config import TrainArgs
from pmgt_tpu_torch.models.ncf import fuse_neumf_params
from pmgt_tpu_torch.train.checkpoints import restore_checkpoint
from pmgt_tpu_torch.train.registry import RunRegistry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARGVS = {
    "train-ncf": {
        "defaults": ["--model-name", "NeuMF-end"],
        "options": ["--model-name", "NeuMF-pre", "--gmf-run-id", "g", "--mlp-run-id", "m",
                    "--alpha", "0.3", "--factor-num", "16", "--num-layers", "2",
                    "--use-layer-norm", "--layer-norm-eps", "1e-6", "--emb-dropout", "0.1",
                    "--dropout", "0.2", "--num-ng", "4", "--max-sample-items", "500",
                    "--freeze-item-init-emb", "--normalize-item-init-emb", "--topk", "50",
                    "--reference-tiebreak", "--early-criterion", "n20", "--tags", "a", "b",
                    "--eval-init", "--swa-start", "2"],
        "unported": ["--model-name", "MLP", "--mp-enabled", "--num-devices", "2",
                     "--profile-dir", "p", "--process-id", "1"],
    },
    "train-dcn": {
        "defaults": ["--model-name", "DCN"],
        "options": ["--model-name", "DCN", "--factor-num", "16", "--deep-net-num-layers", "2",
                    "--cross-net-num-layers", "4", "--use-layer-norm", "--max-sample-items", "9",
                    "--early-criterion", "auc", "--topk", "7", "--scheduler-type", "linear"],
        "unported": ["--model-name", "DCN", "--mp-enabled", "--profile-dir", "p"],
    },
    "train-pmgt-ncf": {
        "defaults": ["--model-name", "MLP"],
        "options": ["--model-name", "NeuMF-end", "--hop-sampling-sizes", "8",
                    "--hop-sampling-sizes", "4", "--hidden-size", "64", "--num-hidden-layers",
                    "2", "--beta", "0.3", "--attention-impl", "xla", "--fusion-strategy",
                    "gather_rows", "--serve-user-batch", "8", "--serve-item-chunk", "256",
                    "--reference-tiebreak", "--max-ctx-neigh", "4"],
        "unported": ["--model-name", "MLP", "--mp-enabled", "--feat-tables-dtype", "int8",
                     "--shard-feat-tables", "--shard-graph-tables", "--num-devices", "4"],
    },
}
SAVE_CASES = [(cmd, name) for cmd in ARGVS for name in ARGVS[cmd]]


@pytest.mark.parametrize("cmd,name", SAVE_CASES)
def test_save_args_json_equals_the_jax_clis(tmp_path, cmd, name):
    argv = [cmd, "--dataset-name", "synth", *ARGVS[cmd][name]]
    jpath, tpath = str(tmp_path / "jax.json"), str(tmp_path / "torch.json")
    res = CliRunner().invoke(jax_cli, ["--save-args", jpath, *argv], obj={})
    assert res.exit_code == 0, res.output
    assert main(["--save-args", tpath, *argv]) is None
    with open(jpath) as f, open(tpath) as g:
        jdict, tdict = json.load(f), json.load(g)
    assert tdict == jdict
    assert TrainArgs.load(jpath).to_dict() == tdict
    assert JTrainArgs.load(tpath).to_dict() == jdict


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    """The synthetic dataset and a small PMGT run's exported embeddings
    ([150, 32]: NCF factor 8 x 2^2, DCN factor 4 x 2^3)."""
    d = tmp_path_factory.mktemp("pipeline")
    data = str(d / "data")
    main(["make-synthetic", "--out-dir", os.path.join(data, "synth"), "--num-nodes", "150",
          "--num-users", "40", "--visual-dim", "32", "--textual-dim", "16", "--avg-degree", "6"])
    pmgt = ["--device", "cpu", "train-pmgt", "--model-name", "pmgt", "--dataset-name", "synth",
            "--data-dir", data, "--log-dir", str(d / "plogs"), "--train-batch-size", "16",
            "--test-batch-size", "64", "--hidden-size", "32", "--intermediate-size", "32",
            "--num-hidden-layers", "1", "--early-criterion", "auc"]
    main([*pmgt, "--num-epochs", "1"])
    (run,) = RunRegistry(str(d / "plogs")).list_runs()
    emb = str(d / "emb.npy")
    main([*pmgt, "--mode", "inference", "--run-id", run.run_id, "--inference-result-path", emb])
    return {"dir": d, "data": data, "emb": emb}


def _cmd(p, cmd, logs, model, *extra):
    return ["--device", "cpu", cmd, "--model-name", model, "--dataset-name", "synth",
            "--data-dir", p["data"], "--log-dir", logs, "--train-batch-size", "32",
            "--test-batch-size", "64", "--num-epochs", "1", *extra]


def test_pmgt_export_feeds_ncf_then_eval_and_inference(tmp_path, pipeline):
    from pmgt_tpu.tasks import ncf_task as jncf_task
    from pmgt_tpu_torch.tasks import ncf_task

    logs = str(tmp_path / "logs")
    ncf = ["--factor-num", "8", "--early-criterion", "n20", "--max-sample-items", "60",
           "--item-init-emb-path", pipeline["emb"]]
    # the MLP item table starts as the export, in both packages
    args = TrainArgs.from_dict(_args_dict(_cmd(pipeline, "train-ncf", logs, "NeuMF-end", *ncf)))
    ctx = {"device": "cpu"}
    ncf_task.init_dataloader(args, ctx)
    ncf_task.init_model(args, ctx)
    emb = np.load(pipeline["emb"])
    table = ctx["task"].model.embed_item_MLP.weight.detach().numpy()
    np.testing.assert_array_equal(table, emb)
    jargs = JTrainArgs.from_dict({**args.to_dict(), "num_devices": 1})
    jctx = {}
    jncf_task.init_dataloader(jargs, jctx)
    jncf_task.init_model(jargs, jctx)
    np.testing.assert_array_equal(
        np.asarray(jctx["task"].state.params["embed_item_MLP"]["embedding"]), table)

    results = main(_cmd(pipeline, "train-ncf", logs, "NeuMF-end", *ncf))
    assert set(results) == {"test/loss", "test/n10", "test/r10", "test/n20", "test/r20"}
    (run,) = RunRegistry(logs).list_runs()
    assert run.status == "FINISHED"
    assert [m["name"] for m in run.metrics() if m["name"].startswith("val/")] == [
        "val/loss", "val/n20", "val/r20"]
    again = main(_cmd(pipeline, "train-ncf", logs, "NeuMF-end", *ncf, "--mode", "eval",
                      "--run-id", run.run_id))
    assert again == results
    npz = str(tmp_path / "top.npz")
    out = main(_cmd(pipeline, "train-ncf", logs, "NeuMF-end", *ncf, "--mode", "inference",
                    "--run-id", run.run_id, "--inference-result-path", npz, "--topk", "20"))
    z = np.load(npz)
    assert z["item_ids"].shape == (40, 20) and z["scores"].dtype == np.float32
    np.testing.assert_array_equal(z["item_ids"], out["item_ids"])
    train = ctx["task"].train_data
    for r, u in enumerate(train.unique_users):
        assert not set(train.user_pos[r, : train.user_pos_count[r]]) & set(z["item_ids"][u])
    assert run.status == "FINISHED" and len(RunRegistry(logs).list_runs()) == 1


def _args_dict(argv):
    """The TrainArgs dict a command line resolves to (through --save-args)."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        main(["--save-args", os.path.join(d, "a.json"), *argv[2:]])
        with open(os.path.join(d, "a.json")) as f:
            return json.load(f)


def test_neumf_pre_fuses_the_best_gmf_and_mlp_runs(tmp_path, pipeline):
    from pmgt_tpu_torch.tasks import ncf_task

    logs = str(tmp_path / "logs")
    small = ["--factor-num", "4", "--num-layers", "2", "--max-sample-items", "30"]
    ids = {}
    for model in ("GMF", "MLP"):
        main(_cmd(pipeline, "train-ncf", logs, model, *small, "--experiment-name", model))
        (run,) = RunRegistry(logs).list_runs(model)
        ids[model] = run.run_id
    pre = [*small, "--gmf-run-id", ids["GMF"], "--mlp-run-id", ids["MLP"], "--alpha", "0.3"]
    args = TrainArgs.from_dict(_args_dict(_cmd(pipeline, "train-ncf", logs, "NeuMF-pre", *pre)))
    ctx = {"device": "cpu"}
    ncf_task.init_dataloader(args, ctx)
    ncf_task.init_model(args, ctx)
    reg = RunRegistry(logs)
    best = {m: restore_checkpoint(reg.get_ckpt_path(ids[m], load_best=True))["state"]["model"]
            for m in ids}
    fresh = ncf_task.NCF(40, 150, factor_num=4, num_layers=2, model="NeuMF-pre")
    fresh.init_weights(torch.Generator().manual_seed(0))
    want = fuse_neumf_params(fresh.state_dict(), best["GMF"], best["MLP"], alpha=0.3)
    for name, value in ctx["task"].model.state_dict().items():
        torch.testing.assert_close(value, want[name], rtol=0, atol=0)
    results = main(_cmd(pipeline, "train-ncf", logs, "NeuMF-pre", *pre, "--eval-init",
                        "--experiment-name", "pre"))
    assert np.isfinite(list(results.values())).all()
    (run,) = reg.list_runs("pre")
    assert run.status == "FINISHED"
    assert [m["epoch"] for m in run.metrics() if m["name"] == "val/loss"] == [-1, 0]


def test_dcn_and_pmgt_ncf_train_eval_inference(tmp_path, pipeline):
    for cmd, model, extra in (
        ("train-dcn", "DCN", ["--factor-num", "4", "--item-init-emb-path", pipeline["emb"],
                              "--freeze-item-init-emb", "--early-criterion", "auc"]),
        ("train-pmgt-ncf", "NeuMF-end", ["--hidden-size", "16", "--intermediate-size", "16",
                                         "--num-hidden-layers", "1", "--factor-num", "4",
                                         "--max-sample-items", "40", "--serve-user-batch", "16",
                                         "--serve-item-chunk", "64"]),
    ):
        logs = str(tmp_path / cmd)
        results = main(_cmd(pipeline, cmd, logs, model, *extra))
        assert np.isfinite(list(results.values())).all()
        (run,) = RunRegistry(logs).list_runs()
        assert run.status == "FINISHED"
        run_id = ["--run-id", run.run_id]
        assert main(_cmd(pipeline, cmd, logs, model, *extra, "--mode", "eval", *run_id)) == results
        npz = str(tmp_path / f"{cmd}.npz")
        main(_cmd(pipeline, cmd, logs, model, *extra, "--mode", "inference", *run_id,
                  "--inference-result-path", npz, "--topk", "10"))
        z = np.load(npz)
        assert z["item_ids"].shape == (40, 10)
        assert ((z["item_ids"] >= 0) & (z["item_ids"] < 150)).all()
    # the frozen DCN item table is still the export
    from pmgt_tpu_torch.data.artifacts import load_node_init_emb

    (run,) = RunRegistry(str(tmp_path / "train-dcn")).list_runs()
    best = restore_checkpoint(RunRegistry(str(tmp_path / "train-dcn")).get_ckpt_path(
        run.run_id, load_best=True))["state"]["model"]
    np.testing.assert_array_equal(best["item_embeddings.weight"].numpy(),
                                  load_node_init_emb(None, None, np.load(pipeline["emb"])))


def test_status_rules(tmp_path, pipeline, monkeypatch):
    from pmgt_tpu_torch.tasks import ncf_task

    logs = str(tmp_path / "logs")
    small = ["--factor-num", "4", "--num-layers", "2", "--max-sample-items", "20"]
    with pytest.raises(ValueError, match="requires --run-id"):
        main(_cmd(pipeline, "train-ncf", logs, "GMF", *small, "--mode", "eval"))

    def broken(*a, **k):
        raise RuntimeError("boom")

    monkeypatch.setattr(ncf_task, "train", broken)
    with pytest.raises(RuntimeError, match="boom"):
        main(_cmd(pipeline, "train-ncf", logs, "GMF", *small))
    (run,) = RunRegistry(logs).list_runs()
    assert run.status == "FAILED"
    monkeypatch.undo()
    main(_cmd(pipeline, "train-ncf", logs, "GMF", *small, "--run-id", run.run_id))
    assert run.status == "FINISHED"
    RunRegistry(logs).set_status(run, "INTERRUPTED")
    main(_cmd(pipeline, "train-ncf", logs, "GMF", *small, "--mode", "eval", "--run-id",
              run.run_id))
    main(_cmd(pipeline, "train-ncf", logs, "GMF", *small, "--mode", "inference", "--run-id",
              run.run_id))
    assert run.status == "INTERRUPTED"


# The multi-GPU options the commands refused before (the test batch of
# PMGT_NCF gives evaluation chunks of 2 users, a multiple of the ranks).
MULTI_GPU = {
    "train-ncf": ["--model-name", "MLP", "--factor-num", "4", "--max-sample-items", "20",
                  "--dropout", "0.1", "--num-devices", "2", "--process-id", "1"],
    "train-dcn": ["--model-name", "DCN", "--factor-num", "4", "--max-sample-items", "5",
                  "--early-criterion", "auc", "--num-devices", "2"],
    "train-pmgt-ncf": ["--model-name", "MLP", "--hidden-size", "32", "--intermediate-size", "16",
                       "--num-hidden-layers", "1", "--factor-num", "4", "--max-sample-items",
                       "20", "--test-batch-size", "128", "--shard-feat-tables",
                       "--shard-graph-tables", "--num-devices", "2"],
}


MULTI_GPU_FLAGS = ("--shard-feat-tables", "--shard-graph-tables")
MULTI_GPU_OPTIONS = ("--num-devices", "--process-id", "--num-processes", "--coordinator-address")


def one_rank_argv(argv):
    """``argv`` without its multi-GPU flags and options (by name)."""
    out, it = [], iter(argv)
    for a in it:
        if a in MULTI_GPU_OPTIONS:
            next(it)
        elif a not in MULTI_GPU_FLAGS:
            out.append(a)
    return out


@pytest.mark.parametrize("cmd", sorted(ARGVS))
def test_unported_options_raise_when_a_run_starts(tmp_path, pipeline, cmd, monkeypatch):
    """The multi-GPU options run: two gloo ranks on the CPU give the
    1-rank run's test metrics; ``--save-args`` records them."""
    from pmgt_tpu_torch.core import mesh as tmesh

    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the spawned ranks' threads
    launched, real = [], tmesh.launch

    def bounded(fn, nprocs, *a, **k):  # counted, and under a deadline
        launched.append(nprocs)
        return real(fn, nprocs, *a, run_timeout_s=300, **k)

    monkeypatch.setattr(tmesh, "launch", bounded)
    argv = MULTI_GPU[cmd]
    one = one_rank_argv(argv)
    assert not set(one) & {*MULTI_GPU_FLAGS, *MULTI_GPU_OPTIONS}
    results = []
    for n, a in ((1, one), (2, argv)):
        results.append(main(["--device", "cpu", cmd, "--dataset-name", "synth", "--data-dir",
                             pipeline["data"], "--log-dir", str(tmp_path / f"logs{n}"),
                             "--train-batch-size", "32", "--num-epochs", "1", *a]))
        assert launched == ([] if n == 1 else [2])  # the reference ran in this process
    assert results[0].keys() == results[1].keys()
    for k, want in results[0].items():
        if k.endswith("loss"):
            assert results[1][k] == pytest.approx(want, rel=2e-4), k
        else:
            assert results[1][k] == want, k
    (run,) = RunRegistry(str(tmp_path / "logs2")).list_runs()
    assert run.status == "FINISHED"
    main(["--save-args", str(tmp_path / "a.json"), cmd, "--dataset-name", "synth", *argv])
    assert os.path.exists(tmp_path / "a.json")


SMALL_RUNS = {
    "train-ncf": ("GMF", ["--factor-num", "4", "--max-sample-items", "20"]),
    "train-dcn": ("DCN", ["--factor-num", "4", "--max-sample-items", "5",
                          "--early-criterion", "auc"]),
    "train-pmgt-ncf": ("MLP", ["--hidden-size", "32", "--intermediate-size", "16",
                               "--num-hidden-layers", "1", "--factor-num", "4",
                               "--max-sample-items", "20"]),
}


@pytest.mark.parametrize("cmd,option", [
    ("train-ncf", ["--mp-enabled"]), ("train-ncf", ["--profile-dir", "PROF"]),
    ("train-dcn", ["--mp-enabled"]), ("train-dcn", ["--profile-dir", "PROF"]),
    ("train-pmgt-ncf", ["--mp-enabled"]), ("train-pmgt-ncf", ["--feat-tables-dtype", "int8"]),
])
def test_published_options_run_one_cpu_step(tmp_path, pipeline, cmd, option):
    """The options the commands refused before now run: one CPU epoch
    (a few steps of 32) and its test."""
    logs = str(tmp_path / "logs")
    model, small = SMALL_RUNS[cmd]
    option = [str(tmp_path / "prof") if x == "PROF" else x for x in option]
    results = main(_cmd(pipeline, cmd, logs, model, *small, *option))
    assert np.isfinite(list(results.values())).all()
    (run,) = RunRegistry(logs).list_runs()
    assert run.status == "FINISHED"
    if "--profile-dir" in option:
        assert any(f.endswith(".pt.trace.json") for f in os.listdir(tmp_path / "prof"))


@pytest.mark.parametrize("cmd", ["train-ncf", "train-dcn"])
def test_mp_enabled_changes_nothing_for_ncf_and_dcn(tmp_path, pipeline, cmd):
    """As in the JAX package, no module of NCF or DCN reads the flag: one
    CPU epoch with and one without it give identical parameters."""
    model, small = SMALL_RUNS[cmd]
    states = []
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for flag in ([], ["--mp-enabled"]):
            logs = str(tmp_path / f"logs{len(flag)}")
            main(_cmd(pipeline, cmd, logs, model, *small, *flag))
            (run,) = RunRegistry(logs).list_runs()
            path = os.path.join(run.ckpt_dir, "last")
            states.append(restore_checkpoint(path)["state"]["model"])
    finally:
        torch.use_deterministic_algorithms(prev)
    assert states[0].keys() == states[1].keys()
    for name in states[0]:
        assert torch.equal(states[0][name], states[1][name]), name


@pytest.mark.parametrize("cmd,model", [("train-ncf", "GMF"), ("train-dcn", "DCN"),
                                       ("train-pmgt-ncf", "MLP")])
def test_runs_default_to_the_card(tmp_path, pipeline, cmd, model):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="cuda"):
        main([cmd, "--model-name", model, "--dataset-name", "synth", "--data-dir",
              pipeline["data"], "--log-dir", str(tmp_path / "logs")])


def test_new_modules_import_without_jax_click_sklearn():
    forbidden = ("jax", "jaxlib", "flax", "optax", "orbax", "pmgt_tpu", "click", "sklearn")
    modules = ["pmgt_tpu_torch.data.interactions", "pmgt_tpu_torch.data.split",
               "pmgt_tpu_torch.models.ncf", "pmgt_tpu_torch.models.dcn",
               "pmgt_tpu_torch.models.pmgt_ncf", "pmgt_tpu_torch.models.initializers",
               "pmgt_tpu_torch.tasks.interaction_base", "pmgt_tpu_torch.tasks.ncf_task",
               "pmgt_tpu_torch.tasks.dcn_task", "pmgt_tpu_torch.tasks.pmgt_ncf_task",
               "pmgt_tpu_torch.cli.main"]
    code = (
        "import sys, importlib\n"
        f"for m in {forbidden!r}: sys.modules[m] = None\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
