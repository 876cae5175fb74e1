"""The port's HPO evidence tools against the JAX package's (CPU, small sizes).

- ``tools/hpo_tg_study``: the substituted space, read back as
  ``hp-tuning`` reads it, equals the JAX tool's ``substitute_space`` for
  the same exports and run id; ``ARM_DIM`` and the study's targets are
  the JAX tool's; each stage's command line is the JAX tool's (the
  pre-training and export captured from the JAX function, the others
  transcribed with their ``file:line``); the signal defaults to 0.5, where
  the JAX tool's lookup now yields 1.0 (a reference defect, recorded here).
- ``tools/hpo_pmgt_study``: the trial configuration and the restore.
- The extension loop, ``compare_to_jax`` at each bound and just past it,
  and the launch formula against a count by hand and the card's record.
- ``cli_runner.run_processes``: each process timed at its own exit (two
  started together, 0.1 s and 1.5 s), and a failed one raising with its
  log while the others are stopped.
- Both studies end to end on a small dataset written in advance into
  ``<work>/data/TG``: one trial of one epoch, one ``hp-tuning`` round;
  the JAX tools' keys with finite values, and each restore equal to its
  trial's logged results within 1e-5.

The module trains on one thread, and its subprocesses too.
"""
from __future__ import annotations

import json
import math
import os
import sys
import time

import numpy as np
import pytest
import torch

from pmgt_tpu_torch.cli import hpo
from pmgt_tpu_torch.data.artifacts import save_native
from pmgt_tpu_torch.data.synthetic import make_synthetic_dataset
from pmgt_tpu_torch.tools import cli_runner as cr
from pmgt_tpu_torch.tools import hpo_pmgt_study as hpm
from pmgt_tpu_torch.tools import hpo_tg_study as htg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)  # the JAX package's root tools
import chip_smoke  # noqa: E402
from tools import hpo_pmgt_study as jhpm  # noqa: E402
from tools import hpo_tg_study as jhtg  # noqa: E402

EPS = 1e-9
RID = "0123456789abcdef0123456789abcdef"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads, omp = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(threads)
    if omp is None:
        os.environ.pop("OMP_NUM_THREADS")
    else:
        os.environ["OMP_NUM_THREADS"] = omp


def _record(name):
    with open(os.path.join(REPO, name)) as f:
        return json.load(f)


# ---------------------------------------------------------------- against the JAX tools
def test_substituted_space_equals_the_jax_tools(tmp_path):
    emb = {d: f"/x/TG/node_feat_{d}dim.npy" for d in (32, 64, 128)}
    path = str(tmp_path / "space.json")
    with open(path, "w") as f:
        json.dump(htg.substitute_space(emb, RID), f)
    assert hpo._load_space(path) == jhtg.substitute_space(emb, RID)
    text = json.dumps(hpo._load_space(path))
    assert "node_feat4_32dim" not in text and RID in text


def test_arms_and_targets_equal_the_jax_tools():
    assert htg.ARM_DIM == jhtg.ARM_DIM
    assert (htg.MIN_COMPLETE, htg.MIN_PRUNED) == (jhtg.MIN_COMPLETE, jhtg.MIN_PRUNED)
    assert (hpm.MIN_COMPLETE, hpm.MIN_PRUNED) == (jhpm.MIN_COMPLETE, jhpm.MIN_PRUNED)
    for (fn, nl), d in htg.ARM_DIM.items():  # the MLP's input width
        assert d == fn * 2 ** (nl - 1)


def _jax_main_until_first_cli(module, monkeypatch, tmp_path):
    """The JAX tool's ``main`` up to its first CLI call: that call's args."""
    seen = []

    class Stop(Exception):
        pass

    def run_cli(args, **_):
        seen.append([str(a) for a in args])
        raise Stop

    monkeypatch.setattr(module, "run_cli", run_cli)
    monkeypatch.setattr(sys, "argv", ["tool", "--work", str(tmp_path)])
    with pytest.raises(Stop):
        module.main()
    return seen[0]


def test_signal_default_is_calibrated_where_the_jax_lookup_falls_back(monkeypatch, tmp_path):
    # tools/hpo_tg_study.py:140-147 looks for ``CALIBRATED_SIGNAL = {...}`` in
    # tools/validate_pipeline.py, which imports the name instead: the JAX tool
    # builds TG at signal 1.0 while its record says 0.5 (a reference defect)
    jax_args = _jax_main_until_first_cli(jhtg, monkeypatch, tmp_path / "j")
    assert jax_args[:2] == ["make-synthetic", "--out-dir"]
    assert jax_args[jax_args.index("--signal") + 1] == "1.0"
    assert _record("HPO_TG_MLP_PMGT.json")["signal"] == 0.5
    assert htg.parse([]).signal == 0.5 == hpm.parse([]).signal
    # the PMGT study's JAX tool reads the calibrated value itself
    jax_args = _jax_main_until_first_cli(jhpm, monkeypatch, tmp_path / "p")
    assert jax_args[jax_args.index("--signal") + 1] == "0.5"


def test_pretrain_and_export_commands_equal_the_jax_tools(monkeypatch):
    calls = []

    def run_cli(args, **_):
        calls.append([str(a) for a in args])
        return f"run_id: {RID}"

    monkeypatch.setattr(jhtg, "run_cli", run_cli)
    rid, emb = jhtg.pretrain_and_export("D", "L", 64, 8)
    assert rid == RID and emb == os.path.join("D", "TG", "node_feat_64dim.npy")
    assert calls[0] == [str(a) for a in htg.pretrain_args("D", "L", 64, 8)]
    assert calls[1] == [str(a) for a in htg.export_args("D", "L", 64, RID, emb)]


def test_gmf_command_equals_the_jax_tools():  # tools/hpo_tg_study.py:179-188
    jax = [
        "train-ncf", "--model-name", "GMF", "--dataset-name", "TG",
        "--data-dir", "D", "--log-dir", "L",
        "--num-epochs", 8, "--train-batch-size", 256,
        "--test-batch-size", 512, "--lr", 1e-3, "--decay", 0.0,
        "--early", 4, "--early-criterion", "n20", "--mp-enabled",
        "--gradient-max-norm", 5.0, "--factor-num", 32,
        "--num-ng", 1, "--max-sample-items", 500, "--valid-size", 0.2,
        "--experiment-name", "GMF-for-HPO",
    ]
    assert htg.gmf_args("D", "L") == jax


def test_trial_configs_equal_the_jax_tools():
    # tools/hpo_tg_study.py:200-210
    with open(os.path.join(REPO, "config/hpo/train_ncf_mlp_pmgt_params.json")) as f:
        want = json.load(f)
    want.update(dataset_name="TG", data_dir="D", log_dir="L", num_epochs=12, early=4,
                valid_size=0.2, experiment_name="MLP-PMGT-HPO-TG", item_init_emb_path="E32",
                max_sample_items=500)
    assert htg.train_params("D", "L", 12, "E32") == want
    # tools/hpo_pmgt_study.py:80-88
    with open(os.path.join(REPO, "config/hpo/train_pmgt_params.json")) as f:
        want = json.load(f)
    want.update(dataset_name="TG", data_dir="D", log_dir="L", num_epochs=6, early=3,
                train_batch_size=256, test_batch_size=512, experiment_name="PMGT-HPO-TG")
    assert hpm.train_params("D", "L", 6) == want


def test_restore_commands_equal_the_jax_tools():
    # tools/hpo_tg_study.py:265-280
    best = _record("HPO_TG_MLP_PMGT.json")["best"]
    p = best["params"]
    emb = {32: "E32", 64: "E64", 128: "E128"}
    want = [
        "train-ncf", "--mode", "eval", "--run-id", RID,
        "--model-name", "MLP", "--dataset-name", "TG",
        "--data-dir", "D", "--log-dir", "L",
        "--factor-num", 32, "--num-layers", 2,
        "--item-init-emb-path", "E64",
        "--normalize-item-init-emb", "--mp-enabled",
        "--num-ng", 1, "--max-sample-items", 500, "--valid-size", 0.2,
        "--seed", int(p["seed"]),
        "--dropout", p["dropout"], "--emb-dropout", p["emb_dropout"],
        "--train-batch-size", int(p["train_batch_size"]),
        "--test-batch-size", 512,
    ]
    assert htg.restore_args(best, RID, "D", "L", emb) == want
    # tools/hpo_pmgt_study.py:159-172
    best = _record("HPO_TG_PMGT.json")["best"]
    p, params = best["params"], hpm.train_params("D", "L", 6)
    want = [
        "train-pmgt", "--mode", "eval", "--run-id", RID,
        "--model-name", "PMGT", "--dataset-name", "TG",
        "--data-dir", "D", "--log-dir", "L",
        "--hidden-size", 128, "--intermediate-size", 128,
        "--num-hidden-layers", int(p["num_hidden_layers"]),
        "--beta", p["beta"], "--mask-node-ratio", p["mask_node_ratio"],
        "--lr", p["lr"], "--decay", params["decay"],
        "--gradient-max-norm", params["gradient_max_norm"],
        "--mp-enabled", "--valid-size", params["valid_size"],
        "--early-criterion", "auc",
        "--train-batch-size", 256, "--test-batch-size", 512,
        "--seed", int(p.get("seed", params["seed"])),
    ]
    assert hpm.restore_args(best, RID, "D", "L", params) == want


def test_flags_and_defaults_equal_the_jax_tools():
    ns = htg.parse([])  # tools/hpo_tg_study.py:129-136
    assert (ns.n_trials, ns.pretrain_epochs, ns.trial_epochs, ns.device) == (5, 8, 12, "cuda")
    ns = hpm.parse([])  # tools/hpo_pmgt_study.py:55-61
    assert (ns.n_trials, ns.trial_epochs, ns.device) == (4, 6, "cuda")


# ---------------------------------------------------------------- the loop and the bounds
def test_study_extends_a_trial_at_a_time(monkeypatch, tmp_path):
    # tools/hpo_tg_study.py:226-238: one more trial a round until both
    # counts are met or four rounds ran; each round adds a COMPLETE trial
    path = str(tmp_path / "t.json")
    targets = []

    def run_cli(args, device):
        n = int(args[args.index("--n-trials") + 1])
        targets.append(n)
        with open(path, "w") as f:
            json.dump([{"number": i, "state": "COMPLETE", "value": 0.1, "params": {}}
                       for i in range(n)], f)
        return ""

    monkeypatch.setattr(cr, "run_cli", run_cli)
    out = cr.study([], 2, path, lambda c, p: c >= 4 and p >= 1, "cpu")
    assert targets == [2, 3, 4, 5] and out["n_complete"] == 5 and out["n_pruned"] == 0
    targets.clear()
    out = cr.study([], 2, path, lambda c, p: c >= 3, "cpu")
    assert targets == [2, 3] and out["n_complete"] == 3


def test_launch_formula():
    # TG: 1,084 validation nodes (3 chunks of 512) and 9,750 training nodes
    # (38 steps of 256); the export 22 chunks of 512
    assert cr.pmgt_run_launches(10834, 0.1, 256, 512, 5, 8, tests=0, export_batch=512) == {
        "k1": 5 * (38 * 8 + 3 * 8 + 22), "k2": 5 * 38 * 8, "k3": 0, "k4": 0}
    # a PMGT trial of HPO_TORCH_TG_PMGT.json: 3 layers, 6 epochs, its test
    got = cr.pmgt_run_launches(10834, 0.1, 256, 512, 3, 6)
    assert got == _record("HPO_TORCH_TG_PMGT.json")["trial_records"]["0"]["launches"]
    assert chip_smoke.pmgt_stage_launches(10834, 8) == cr.pmgt_run_launches(
        10834, 0.1, 256, 512, 5, 8, tests=0, export_batch=512)
    assert cr.expected("cpu", got) == cr.NO_LAUNCHES and cr.expected("cuda", got) == got


def _tg_report(value=0.2596, restore_shift=0.0, pruned_arm=(8, 2), dim=64):
    logged = {"test/loss": 0.5, "test/n20": value, "test/r20": 0.44}
    trials = [{"number": i, "state": "COMPLETE", "value": value - 0.01 * i,
               "params": {"factor_num": 32, "num_layers": 2}} for i in range(4)]
    trials.append({"number": 4, "state": "PRUNED", "value": None,
                   "params": {"factor_num": pruned_arm[0], "num_layers": pruned_arm[1]}})
    return {
        "trials": trials, "best": trials[0],
        "trial_records": {str(i): {"results": logged, "emb_dim": dim} for i in range(4)},
        "restore_in_process": {"results": {k: v + restore_shift for k, v in logged.items()}},
        "stages": [],
    }


def test_mlp_study_compare_holds_a_matching_report():
    out = htg.compare_to_jax(_tg_report(), _record("HPO_TG_MLP_PMGT.json"))
    assert out["ok"] and not out["misses"], out


@pytest.mark.parametrize("past", [False, True])
def test_mlp_study_best_and_restore_bounds(past):
    jax = _record("HPO_TG_MLP_PMGT.json")
    floor = jax["best"]["value"] - 0.01
    rep = _tg_report(value=floor + (-1e-6 if past else EPS))
    assert htg.compare_to_jax(rep, jax)["misses"] == (
        ["best value >= JAX best - 0.01"] if past else [])
    rep = _tg_report(restore_shift=1e-5 + (1e-7 if past else -1e-7))
    assert htg.compare_to_jax(rep, jax)["misses"] == (
        ["restored best == its logged results (1e-5)"] if past else [])


def test_mlp_study_arms_must_match():
    jax = _record("HPO_TG_MLP_PMGT.json")
    assert htg.compare_to_jax(_tg_report(pruned_arm=(8, 3)), jax)["misses"] == [
        "every PRUNED trial in a prune arm"]
    assert htg.compare_to_jax(_tg_report(dim=128), jax)["misses"] == [
        "every COMPLETE trial on ARM_DIM's export"]


@pytest.mark.parametrize("past", [False, True])
def test_pmgt_study_bounds(past):
    jax = _record("HPO_TG_PMGT.json")
    launches = {"k1": 12, "k2": 6, "k3": 0, "k4": 0}
    logged = {"test/auc": jax["best"]["value"] - 0.01 + (-1e-6 if past else EPS),
              "test/loss": 0.5}
    rep = {"n_complete": 3, "n_pruned": 0,
           "best": {"number": 0, "value": logged["test/auc"]},
           "trial_records": {str(i): {"results": logged, "launches": launches,
                                      "expected_launches": dict(launches)} for i in range(3)},
           "restore_in_process": {"results": dict(logged), "launches": {"k1": 3}},
           "restore_expected_launches": {"k1": 3}}
    assert hpm.compare_to_jax(rep, jax)["misses"] == (
        ["best value >= JAX best - 0.01"] if past else [])
    rep["trial_records"]["1"]["launches"] = dict(launches, k2=5)
    rep["n_complete"] = 2
    assert set(hpm.compare_to_jax(rep, jax)["misses"]) >= {
        "COMPLETE trials >= 3", "every trial's launches exact"}


def test_frozen_dcn_seed_gap_against_the_records():
    # the frozen real arm: the port's record (seeds 0-2) against JAX's own
    # three seeds; a seed run again reproduces the record's value exactly
    rec = _record("DCN_SENSITIVITY_TORCH_TG_FROZEN.json")["auc_exact"]
    jax = _record("DCN_SENSITIVITY_TG_FROZEN.json")["auc"]
    out = chip_smoke.seed_gap({}, rec, jax)
    assert out["pooled_port"]["n"] == 3 and out["jax"]["n"] == 3
    assert abs(out["jax"]["mean"] - 0.60813) < 1e-9 and abs(out["jax"]["std"] - 0.00689) < 1e-5
    assert abs(out["gap"] - 0.01068) < 1e-5 and abs(out["gap_over_se"] - 2.479) < 1e-3
    more = chip_smoke.seed_gap({0: rec["real_s0"], 3: 0.61}, rec, jax)
    assert more["reproduced"] == {"0": 0.0} and more["pooled_port"]["n"] == 4
    assert more["record_seeds"]["0"] == rec["real_s0"]


def test_run_processes_times_each_process_at_its_exit(tmp_path):
    # started together, the 0.1 s process is timed when it exits, not when
    # the 1.5 s one started before it is reaped
    sleep = "import time; time.sleep({})"
    jobs = {"slow": ([sys.executable, "-c", sleep.format(1.5)], str(tmp_path / "slow.log")),
            "fast": ([sys.executable, "-c", sleep.format(0.1)], str(tmp_path / "fast.log"))}
    seconds = cr.run_processes(jobs)
    assert list(seconds) == ["slow", "fast"]
    assert seconds["fast"] < 1.0 <= 1.5 <= seconds["slow"]


def test_run_processes_raises_when_a_process_fails(tmp_path):
    t0 = time.perf_counter()
    jobs = {"long": ([sys.executable, "-c", "import time; time.sleep(30)"],
                     str(tmp_path / "long.log")),
            "bad": ([sys.executable, "-c", "import sys; print('boom'); sys.exit(3)"],
                    str(tmp_path / "bad.log"))}
    with pytest.raises(RuntimeError, match="bad failed \\(rc 3\\)(.|\n)*boom"):
        cr.run_processes(jobs)
    assert time.perf_counter() - t0 < 15  # the long process was stopped


# ---------------------------------------------------------------- end to end
def _work(tmp_path_factory, name):
    work = str(tmp_path_factory.mktemp(name))
    art = make_synthetic_dataset(num_nodes=300, num_users=150, feat_dims=(64, 32), seed=42)
    save_native(os.path.join(work, "data", "TG"), art)
    return work


def _finite(obj):
    if isinstance(obj, dict):
        return all(_finite(v) for v in obj.values())
    if isinstance(obj, list):
        return all(_finite(v) for v in obj)
    return not isinstance(obj, float) or math.isfinite(obj)


@pytest.fixture(scope="module")
def mlp_study(tmp_path_factory):
    work = _work(tmp_path_factory, "hpo_tg")
    ns = htg.parse(["--work", work, "--out", work + ".json", "--n-trials", "1",
                    "--pretrain-epochs", "1", "--trial-epochs", "1", "--device", "cpu"])
    return htg.run(ns, rounds=1), work


def test_mlp_study_end_to_end(mlp_study):
    rep, work = mlp_study
    jax = _record("HPO_TG_MLP_PMGT.json")
    assert set(jax) <= set(rep) and _finite(rep)
    with open(work + ".json") as f:
        assert json.load(f) == json.loads(json.dumps(rep))
    stages = [s["stage"] for s in rep["stages"]]
    assert stages == ["dataset", "pretrain_h32", "pretrain_h64", "pretrain_h128", "gmf"]
    for d in (32, 64, 128):
        emb = np.load(os.path.join(work, "data", "TG", f"node_feat_{d}dim.npy"))
        assert emb.shape == (300, d) and np.isfinite(emb).all()
    assert rep["n_complete"] == 1 and len(rep["trials"]) == 1 + rep["n_pruned"]
    assert set(rep["best_restore_eval"]) == set(jax["best_restore_eval"])
    best = rep["trial_records"][str(rep["best"]["number"])]
    assert best["value"] == rep["best"]["value"] and best["epochs"] == 1
    assert best["emb_dim"] == htg.ARM_DIM[(rep["best"]["params"]["factor_num"],
                                           rep["best"]["params"]["num_layers"])]
    assert cr.restore_check(best["results"], rep["restore_in_process"]["results"])["ok"]
    # the space the study read: JSON, with the exports and the GMF run in it
    with open(os.path.join(work, "hpo_ncf_mlp_pmgt_params.TG.json")) as f:
        text = f.read()
    assert rep["stages"][-1]["run_id"] in text and "node_feat_128dim.npy" in text
    out = htg.compare_to_jax(rep, jax)
    assert "PMGT stages' launches exact" not in out["misses"]


@pytest.fixture(scope="module")
def pmgt_study(tmp_path_factory):
    work = _work(tmp_path_factory, "hpo_pmgt")
    ns = hpm.parse(["--work", work, "--out", work + ".json", "--n-trials", "1",
                    "--trial-epochs", "1", "--device", "cpu"])
    return hpm.run(ns, rounds=1), work


def test_pmgt_study_end_to_end(pmgt_study):
    rep, work = pmgt_study
    jax = _record("HPO_TG_PMGT.json")
    assert set(jax) - {"pruning_note"} <= set(rep) and _finite(rep)
    assert rep["n_complete"] == 1 and rep["n_pruned"] == 0
    assert set(rep["best_restore_eval"]) == set(jax["best_restore_eval"])
    rec = rep["trial_records"][str(rep["best"]["number"])]
    assert rec["hidden_size"] in (32, 64, 128) and 0.0 <= rec["beta"] <= 1.0
    assert cr.restore_check(rec["results"], rep["restore_in_process"]["results"])["ok"]
    out = hpm.compare_to_jax(rep, jax)
    assert {"every trial's launches exact", "restore launches exact"}.isdisjoint(out["misses"])
