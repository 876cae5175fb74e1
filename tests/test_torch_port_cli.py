"""The port's command line against the JAX package's, and ``train-pmgt``
end to end on the CPU.

- ``--save-args`` writes the JAX CLI's JSON for the same argv (the JAX side
  through ``click.testing.CliRunner`` on ``pmgt_tpu.cli.main.cli``, the port
  through ``main(argv)``), and each package loads the other's file.
- ``make-synthetic`` writes the JAX command's dataset.
- ``make-synthetic`` → ``train-pmgt`` (2 epochs) → resume to 3 →
  ``--mode eval`` → ``--mode inference`` at a few layers and narrow widths:
  status, checkpoints, metrics rows, the exported ``[num_nodes, hidden]``
  float32 ``.npy``, and eval leaving the run's status as it was (the JAX
  CLI relabels it).
- The multi-GPU options run: ``--shard-feat-tables`` in one process,
  ``--num-devices 2`` as two gloo ranks on the CPU (one run, FINISHED),
  and a coordinator address without the rest of the multi-host trio is
  refused before a run is created; ``hp-tuning`` with more than one
  device is the one refusal left, naming its ROADMAP item. Every other
  option runs (one CPU step each), and the published training scripts'
  argument lists parse and pass ``check_args``.
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
from click.testing import CliRunner

from pmgt_tpu.cli import data_cmds as _jax_data_cmds  # noqa: F401  (registers make-synthetic)
from pmgt_tpu.cli.main import cli as jax_cli
from pmgt_tpu.core.config import TrainArgs as JTrainArgs
from pmgt_tpu_torch.cli.main import _make_args, build_parser, main
from pmgt_tpu_torch.core.config import TrainArgs
from pmgt_tpu_torch.data.artifacts import load_artifacts
from pmgt_tpu_torch.train.checkpoints import read_best_info
from pmgt_tpu_torch.train.registry import RunRegistry

REQUIRED = ["--model-name", "pmgt", "--dataset-name", "synth"]
ARGVS = {
    "defaults": [],
    "options": [
        "--seed", "7", "--num-epochs", "3", "--lr", "0.002", "--early", "2",
        "--early-criterion", "auc", "--train-batch-size", "64",
        "--gradient-max-norm", "1.5", "--accumulation-step", "2",
        "--scheduler-warmup", "0.1", "--scheduler-type", "cosine",
        "--tags", "team", "recsys", "--tags", "k", "v", "--eval-interval", "2",
        "--ckpt-interval", "3", "--swa-start", "1", "--eval-init",
        "--hop-sampling-sizes", "8", "--hop-sampling-sizes", "4",
        "--hidden-size", "64", "--attention-impl", "xla", "--no-scan-epoch",
        "--fusion-strategy", "gather_rows", "--run-name", "r1",
    ],
    "unported": [
        "--mp-enabled", "--gradient-checkpointing", "--no-ctx-cache",
        "--shard-feat-tables", "--shard-graph-tables", "--feat-tables-dtype",
        "int8", "--num-devices", "4", "--profile-dir", "/tmp/prof",
        "--position-embedding-type", "relative_key", "--num-processes", "2",
    ],
}


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_save_args_json_equals_the_jax_clis(tmp_path, name):
    argv = ["train-pmgt", *REQUIRED, *ARGVS[name]]
    jpath, tpath = str(tmp_path / "jax.json"), str(tmp_path / "torch.json")
    res = CliRunner().invoke(jax_cli, ["--save-args", jpath, *argv], obj={})
    assert res.exit_code == 0, res.output
    assert main(["--save-args", tpath, *argv]) is None
    with open(jpath) as f, open(tpath) as g:
        jdict, tdict = json.load(f), json.load(g)
    assert tdict == jdict
    assert TrainArgs.load(jpath).to_dict() == tdict
    assert JTrainArgs.load(tpath).to_dict() == jdict


def test_make_synthetic_writes_the_jax_commands_dataset(tmp_path):
    opts = ["--num-nodes", "60", "--num-users", "30", "--visual-dim", "16",
            "--textual-dim", "8", "--avg-degree", "4", "--seed", "2"]
    res = CliRunner().invoke(
        jax_cli, ["make-synthetic", "--out-dir", str(tmp_path / "J"), *opts], obj={})
    assert res.exit_code == 0, res.output
    main(["make-synthetic", "--out-dir", str(tmp_path / "T"), *opts])
    j, t = load_artifacts(str(tmp_path), "J"), load_artifacts(str(tmp_path), "T")
    for name in ("nbr_ids", "nbr_logits", "degrees", "alias_prob", "alias_idx"):
        np.testing.assert_array_equal(getattr(t.graph, name), getattr(j.graph, name))
    for a, b in zip(t.feat_init_embs, j.feat_init_embs, strict=True):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.train_pairs, j.train_pairs)


SMALL = ["--train-batch-size", "16", "--test-batch-size", "32", "--hidden-size", "32",
         "--intermediate-size", "32", "--num-hidden-layers", "2",
         "--early-criterion", "auc"]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    main(["make-synthetic", "--out-dir", str(d / "synth"), "--num-nodes", "150",
          "--num-users", "40", "--visual-dim", "64", "--textual-dim", "32",
          "--avg-degree", "6"])
    return str(d)


def _cmd(data_dir, log_dir, *extra):
    return ["--device", "cpu", "train-pmgt", *REQUIRED, "--data-dir", data_dir,
            "--log-dir", log_dir, *SMALL, *extra]


def test_train_resume_eval_inference_on_cpu(tmp_path, data_dir, capsys):
    logs = str(tmp_path / "logs")
    results = main(_cmd(data_dir, logs, "--num-epochs", "2"))
    assert set(results) == {"test/auc", "test/loss"}
    reg = RunRegistry(logs)
    (run,) = reg.list_runs()
    assert run.status == "FINISHED"
    assert {n for n in ("best", "last") if os.path.isdir(os.path.join(run.ckpt_dir, n))} == {"best", "last"}
    best = read_best_info(run.ckpt_dir)
    assert best["monitor"] == "val/auc"
    rows = [m for m in run.metrics() if m["name"] == "val/auc"]
    steps = rows[0]["step"]
    assert steps == 120 // 16  # 150 nodes, 30 of them valid
    assert [m["epoch"] for m in rows] == [0, 1] and [m["step"] for m in rows] == [steps, 2 * steps]
    assert run.params["hidden_size"] == 32

    # resume to a third epoch: the hyperparameters come from the run
    main(["--device", "cpu", "train-pmgt", *REQUIRED, "--data-dir", data_dir,
          "--log-dir", logs, "--train-batch-size", "16", "--test-batch-size", "32",
          "--early-criterion", "auc", "--num-epochs", "3", "--run-id", run.run_id])
    rows = [m for m in run.metrics() if m["name"] == "val/auc"]
    assert [m["epoch"] for m in rows] == [0, 1, 2] and rows[-1]["step"] == 3 * steps
    assert run.status == "FINISHED"

    # eval leaves the status as it was, whatever it was
    reg.set_status(run, "INTERRUPTED")
    out = main(_cmd(data_dir, logs, "--mode", "eval", "--run-id", run.run_id))
    assert np.isfinite(list(out.values())).all() and run.status == "INTERRUPTED"

    path = str(tmp_path / "out" / "emb.npy")
    emb = main(_cmd(data_dir, logs, "--mode", "inference", "--run-id", run.run_id,
                    "--inference-result-path", path))
    saved = np.load(path)
    assert saved.shape == (150, 32) and saved.dtype == np.float32
    assert np.isfinite(saved).all() and np.array_equal(saved, emb)
    assert run.status == "INTERRUPTED" and len(reg.list_runs()) == 1

    capsys.readouterr()
    main(["runs", "--log-dir", logs])
    main(["runs", "--log-dir", logs, "--run-id", run.run_id])
    printed = capsys.readouterr().out
    assert run.run_id in printed and "INTERRUPTED" in printed
    assert f"best: val/auc = {best['value']:.6g}" in printed


def test_eval_and_inference_need_a_run_with_a_checkpoint(tmp_path, data_dir):
    logs = str(tmp_path / "logs")
    with pytest.raises(ValueError, match="requires --run-id"):
        main(_cmd(data_dir, logs, "--mode", "eval"))
    run = RunRegistry(logs).create_run("baseline", {})
    with pytest.raises(FileNotFoundError, match="refusing"):
        main(_cmd(data_dir, logs, "--mode", "eval", "--run-id", run.run_id))
    assert run.status == "RUNNING"  # not this invocation's run


@pytest.mark.parametrize("option", [
    ["--shard-feat-tables"], ["--num-devices", "2"],
    ["--coordinator-address", "localhost:1234"],
])
def test_unported_options_raise_when_a_run_starts(tmp_path, data_dir, option, monkeypatch):
    """The multi-GPU options the port refused before: the shard flag and
    two ranks run one CPU epoch; a coordinator address alone is refused
    before any run is created."""
    from pmgt_tpu_torch.core import mesh as tmesh

    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the spawned ranks' threads
    real = tmesh.launch
    monkeypatch.setattr(tmesh, "launch",
                        lambda *a, **k: real(*a, run_timeout_s=300, **k))  # under a deadline
    logs = str(tmp_path / "logs")
    if option[0] == "--coordinator-address":
        with pytest.raises(ValueError, match="--num-processes"):
            main(_cmd(data_dir, logs, *option))
        assert not os.path.exists(logs)
    else:
        results = main(_cmd(data_dir, logs, *option, "--num-epochs", "1",
                            "--train-batch-size", "96"))
        assert np.isfinite(list(results.values())).all()
        (run,) = RunRegistry(logs).list_runs()
        assert run.status == "FINISHED"
    main(["--save-args", str(tmp_path / "a.json"), *_cmd(data_dir, logs, *option)[2:]])
    assert os.path.exists(tmp_path / "a.json")


def test_every_unported_option_is_named(tmp_path):
    """What a trial refuses is named: the multi-host trio (a study is one
    host's, as in the JAX package); several devices in a trial now run."""
    from pmgt_tpu_torch.cli import hpo

    for extra in ({"coordinator_address": "localhost:1"}, {"process_id": 1}):
        with pytest.raises(NotImplementedError, match="multi-host options"):
            hpo._objective(hpo.RandomTrial(0, np.random.default_rng(0)),
                           {"log_dir": str(tmp_path), **extra}, {}, "pmgt", "test/auc", False,
                           "cpu")


@pytest.mark.parametrize("option", [
    ["--mp-enabled"], ["--gradient-checkpointing"], ["--no-ctx-cache"],
    ["--feat-tables-dtype", "bfloat16"], ["--feat-tables-dtype", "int8"],
    ["--profile-dir", "PROF"], ["--position-embedding-type", "relative_key"],
])
def test_published_options_run_one_cpu_step(tmp_path, data_dir, option):
    """The options ``train-pmgt`` refused before now run: one epoch of one
    step (120 training nodes, batches of 96), its evaluation and test."""
    logs = str(tmp_path / "logs")
    option = [str(tmp_path / "prof") if x == "PROF" else x for x in option]
    results = main(_cmd(data_dir, logs, *option, "--num-epochs", "1",
                        "--train-batch-size", "96"))
    assert np.isfinite(list(results.values())).all()
    (run,) = RunRegistry(logs).list_runs()
    assert run.status == "FINISHED"
    assert [m["step"] for m in run.metrics() if m["name"] == "val/auc"] == [1]
    if "--profile-dir" in option:
        assert any(f.endswith(".pt.trace.json") for f in os.listdir(tmp_path / "prof"))


def test_profile_dir_trace_holds_the_programs_spans(tmp_path, data_dir):
    """``--mode train --profile-dir`` on the CPU: the trace holds the
    program's ``pmgt:`` spans of the engine, the refresh and the step."""
    prof = tmp_path / "prof"
    main(_cmd(data_dir, str(tmp_path / "logs"), "--profile-dir", str(prof),
              "--num-epochs", "1", "--train-batch-size", "96"))
    (name,) = [f for f in os.listdir(prof) if f.endswith(".pt.trace.json")]
    with open(prof / name) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"pmgt:step", "pmgt:epoch", "pmgt:evaluate", "pmgt:checkpoint", "pmgt:forward",
            "pmgt:backward", "pmgt:optimizer", "pmgt:batch", "pmgt:refresh"} <= names


TRAINING_SCRIPTS = ("run_pmgt", "run_pmgt_ncf", "run_ncf", "run_dcn", "run_gmf", "run_mlp",
                    "run_neumf_pre")


def _script_argv(path, emb_path):
    """The command and arguments a ``scripts/run_*.sh`` passes to ``python
    main.py``: its ``args=( ... )`` array or its continued command line,
    with the shell variables bound (seed 0, the TG dataset, run ids g and m,
    the item embeddings at ``emb_path``)."""
    import re
    import shlex

    with open(path) as f:
        text = f.read().replace("\\\n", " ")
    array = re.search(r"^args=\((.*?)^\)", text, re.S | re.M)
    (line,) = [x for x in text.splitlines() if x.startswith("python main.py")]
    words = shlex.split(line)[2:]
    if array:
        body = "\n".join(x for x in array.group(1).splitlines()
                         if not x.strip().startswith("#"))
        words = [words[0], *shlex.split(body)]
    subst = {"$0": path, "$DATASET": "TG", "$SEED": "0", "$2": "g", "$3": "m"}
    out = []
    for w in words:
        if w.startswith("./data/"):
            w = emb_path
        for k, v in subst.items():
            w = w.replace(k, v)
        out.append(w)
    return out


@pytest.mark.parametrize("script", TRAINING_SCRIPTS)
def test_published_training_scripts_parse_and_pass_check_args(tmp_path, script):
    """Every published training script's argument list is taken by the
    port's parser, and the workload's ``check_args`` raises nothing (no
    option of theirs is refused)."""
    import importlib

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    emb = tmp_path / "emb.npy"
    np.save(emb, np.zeros((4, 4), np.float32))
    argv = _script_argv(os.path.join(root, "scripts", f"{script}.sh"), str(emb))
    assert argv[0].startswith("train-") and "--mp-enabled" in argv
    ns = build_parser().parse_args(argv)
    args = _make_args({k: v for k, v in vars(ns).items()
                       if k not in ("save_args", "device", "command", "handler")})
    assert args.mp_enabled and args.model_name and args.dataset_name == "TG"
    name = argv[0][len("train-"):].replace("-", "_")
    importlib.import_module(f"pmgt_tpu_torch.tasks.{name}_task").check_args(args)


# ---- hp-tuning and the data commands -----------------------------------------

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HPO_SCRIPTS = sorted(f[:-3] for f in os.listdir(os.path.join(ROOT, "scripts"))
                     if f.startswith("run_hpo_"))


def _jax_command(name):
    """The JAX package's click command ``name`` (its module registers it)."""
    from pmgt_tpu.cli import hpo as _jax_hpo  # noqa: F401  (registers hp-tuning)

    return jax_cli.commands[name]


def _port_params(ns):
    return {k: v for k, v in vars(ns).items()
            if k not in ("save_args", "device", "command", "handler")}


def test_every_hpo_script_is_checked():
    assert len(HPO_SCRIPTS) == 9


@pytest.mark.parametrize("script", HPO_SCRIPTS)
def test_hpo_scripts_parse_to_the_jax_commands_params(tmp_path, monkeypatch, script):
    """Each ``scripts/run_hpo_*.sh`` argument list (``$1`` at its default)
    parses in the port to the parameters the JAX click command takes."""
    import re

    monkeypatch.chdir(ROOT)
    with open(os.path.join(ROOT, "scripts", f"{script}.sh")) as f:
        text = re.sub(r'"\$\{1:-(\d+)\}"', r"\1", f.read())
    (tmp_path / "script.sh").write_text(text)
    argv = _script_argv(str(tmp_path / "script.sh"), "unused")
    assert argv[0] == "hp-tuning"
    ns = build_parser().parse_args(["--device", "cpu", *argv])
    want = _jax_command("hp-tuning").make_context("hp-tuning", argv[1:]).params
    assert _port_params(ns) == want
    assert ns.device == "cpu" and ns.n_trials in (20, 50)


@pytest.mark.parametrize("command,argv", [
    ("hp-tuning", ["--hp-config-path", "config/hpo/hpo_pmgt_params.yaml",
                   "--train-config-path", "config/hpo/train_pmgt_params.json"]),
    ("hp-tuning", ["--hp-config-path", "config/hpo/hpo_ncf_params.yaml",
                   "--train-config-path", "config/hpo/train_ncf_params.json",
                   "--n-trials", "3", "--study-name", "s", "--storage-path", "/x/y.db",
                   "--train-name", "pmgt_ncf", "--enable-trial-pruning"]),
    ("preprocess", ["--raw-dir", "r", "--out-dir", "o", "--dataset-name", "TG"]),
    ("preprocess", ["--raw-dir", "r", "--out-dir", "o", "--dataset-name", "TG",
                    "--min-common-users", "2", "--split-date", "2014-01-01",
                    "--test-size", "0.1", "--seed", "3", "--extract-features",
                    "--text-model", "t", "--image-model", "i", "--feature-device", "cuda",
                    "--download"]),
    ("preprocess", ["--raw-dir", "r", "--out-dir", "o", "--dataset-name", "TG",
                    "--no-extract-features"]),
    ("scrape-images", ["--meta-path", "config/hpo/train_ncf_params.json", "--image-dir", "i"]),
    ("scrape-images", ["--meta-path", "config/hpo/train_ncf_params.json", "--image-dir", "i",
                       "--max-workers", "2", "--max-retries", "1", "--backoff", "2.5"]),
])
def test_option_defaults_equal_the_jax_commands(monkeypatch, command, argv):
    """Same options, same defaults: the parsed parameters equal the JAX
    click command's for the same argument list."""
    monkeypatch.chdir(ROOT)
    ns = build_parser().parse_args([command, *argv])
    want = _jax_command(command).make_context(command, list(argv)).params
    got = _port_params(ns)
    if command == "preprocess" and "--feature-device" not in argv:
        # the port's extractors follow --device (the card); the JAX default is the CPU
        assert got.pop("feature_device") is None and want.pop("feature_device") == "cpu"
    assert got == want


def test_preprocess_command_passes_what_the_jax_command_passes(tmp_path, monkeypatch):
    """Through ``CliRunner`` (JAX) and ``main`` (port), ``preprocess``
    hands ``run_preprocess`` the same arguments, but for ``feature_device``:
    the port's follows ``--device`` (the card), the JAX command's is the
    CPU."""
    from pmgt_tpu.data import preprocess as jpre
    from pmgt_tpu_torch.data import preprocess as tpre

    seen = {}
    monkeypatch.setattr(jpre, "run_preprocess", lambda **kw: seen.setdefault("jax", kw))
    monkeypatch.setattr(tpre, "run_preprocess", lambda **kw: seen.setdefault("torch", kw))
    argv = ["preprocess", "--raw-dir", "r", "--out-dir", "o", "--dataset-name", "VG",
            "--test-size", "0.3", "--extract-features", "--download"]
    res = CliRunner().invoke(jax_cli, argv, obj={})
    assert res.exit_code == 0, res.output
    main(argv)
    jax_kw, torch_kw = dict(seen["jax"]), dict(seen["torch"])
    assert jax_kw.pop("feature_device") == "cpu" and torch_kw.pop("feature_device") == "cuda"
    assert torch_kw == jax_kw
    seen.clear()
    main(["--device", "cpu", *argv, "--feature-device", "cuda:1"])
    assert seen["torch"]["feature_device"] == "cuda:1"
