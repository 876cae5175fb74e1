"""``hp-tuning`` over several ranks (``pmgt_tpu_torch/cli/hpo.py``) on the
CPU: gloo ranks that ``core.mesh.launch`` spawns, one torch thread each,
every launch under a run deadline.

- ``main([... "hp-tuning" ...])`` with ``num_devices: 2`` in the train
  config, on PMGT and on NCF: one launch for the study; the trials JSON
  holds the COMPLETE and PRUNED trials, written by rank 0 alone; both ranks
  trained the same trials; each COMPLETE trial's objective equals a 1-rank
  re-run of its recorded parameters and a 1-rank evaluation of its best
  checkpoint (AUC within 1e-5; NCF's n20 and r20 equal); a resumed study
  adds exactly the missing trials.
- A ``prune: true`` arm prunes on every rank without training; with
  ``--enable-trial-pruning`` every rank's task asks ``should_prune`` after
  each epoch, without it none does.
- A rank-0 trial that prunes at epoch 1 stops both ranks after epoch 1.
- ``num_devices`` unset on the CPU runs one rank in this process; a
  ``num_devices`` suggested by the space and the multi-host trio in the
  train config are refused before any run.
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest

from pmgt_tpu_torch.cli import hpo
from pmgt_tpu_torch.cli.main import main, train_args, train_model
from pmgt_tpu_torch.core import mesh as tmesh
from pmgt_tpu_torch.data.artifacts import save_native
from pmgt_tpu_torch.data.synthetic import make_synthetic_dataset
from pmgt_tpu_torch.train.registry import RunRegistry

import torch_port_ranks as ranks

TIMEOUT = 300  # s, every launch and every collective in it

PMGT_SPACE = """\
lr:
  type: float
  value: [1.0e-4, 1.0e-2]
  round: 6
hidden_size:
  type: categorical
  value: [8, 16]
beta:
  type: float
  value: [0.0, 1.0]
  step: 0.5
"""
NCF_SPACE = """\
factor_num:
  type: categorical
  value: [4, 8]
  cond:
    - cond_type: eq
      cond_value: 4
      prune: true
dropout:
  type: float
  step: 0.1
  value: [0.0, 0.3]
  round: 1
"""


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("hpo_mr_data")
    art = make_synthetic_dataset(num_nodes=90, num_users=40, feat_dims=(12, 8),
                                 avg_degree=5, interactions_per_user=8, seed=0)
    save_native(str(d / "S"), art)
    return str(d)


@pytest.fixture
def launches(monkeypatch):
    """Every launch under a deadline and one torch thread a rank; the
    ranks' results of each study, in order."""
    seen = []
    real_launch, real_study = tmesh.launch, hpo.launch_study
    monkeypatch.setattr(tmesh, "launch", lambda *a, **k: real_launch(
        *a, run_timeout_s=TIMEOUT, timeout_s=TIMEOUT, num_threads=1, **k))
    monkeypatch.setattr(hpo, "launch_study",
                        lambda spec: seen.append(real_study(spec)) or seen[-1])
    return seen


def _configs(tmp_path, data_dir, name, **extra):
    if name == "pmgt":
        space, train = PMGT_SPACE, {
            "model_name": "PMGT", "early_criterion": "auc", "train_batch_size": 16,
            "test_batch_size": 32, "num_hidden_layers": 1, "intermediate_size": 16,
            "hop_sampling_sizes": [4, 2]}
    else:
        space, train = NCF_SPACE, {
            "model_name": "NeuMF-end", "early_criterion": "n20", "train_batch_size": 32,
            "test_batch_size": 32, "num_layers": 2, "max_sample_items": 20, "num_epochs": 2,
            "early": 0}
    train = {"num_epochs": 1, **train, "dataset_name": "S", "data_dir": data_dir,
             "log_dir": str(tmp_path / "logs"), "seed": 0, **extra}
    (tmp_path / "space.yaml").write_text(space)
    (tmp_path / "train.json").write_text(json.dumps(train))
    argv = ["--device", "cpu", "hp-tuning", "--hp-config-path", str(tmp_path / "space.yaml"),
            "--train-config-path", str(tmp_path / "train.json"), "--train-name", name,
            "--study-name", f"{name}-study", "--storage-path", str(tmp_path / "hpo" / "db")]
    return argv, train


class Replay:
    """A trial's recorded draws, replayed through the space."""

    def __init__(self, params):
        self.params = params

    def suggest_categorical(self, name, choices):
        return self.params[name]

    def suggest_float(self, name, *args, **kwargs):
        return self.params[name]

    suggest_int = suggest_float


def _one_rank_rerun(name, train, tmp_path, stored, **extra):
    """The trial's parameters (its draws through the space) as a 1-rank
    trial in this process (``extra``: ``mode="eval"`` and its run id
    evaluate the trial's best checkpoint instead): its test results."""
    space = hpo._load_space(str(tmp_path / "space.yaml"))
    params = {**train, **hpo.get_hp_params(Replay(stored["params"]), space), "num_devices": 1,
              "log_dir": str(tmp_path / "rerun"), **extra}
    return train_model(name, train_args(params), device="cpu", is_hptuning=True)


def _check_study(study, stored, name, train, tmp_path, criterion, pruning_epochs):
    """Both ranks trained the trials rank 0's study stored, in order; each
    COMPLETE objective equals its 1-rank re-run; PRUNED trials trained
    nowhere."""
    rank0, rank1 = (r["trials"] for r in study)
    assert study[1]["best"] is None and study[0]["best"] is not None
    got = [(t["number"], t["params"], t["state"]) for t in rank0]
    assert got == [(t["number"], t["params"], t["state"]) for t in rank1]
    by_number = {t["number"]: t for t in stored}
    assert got == [(n, by_number[n]["params"], by_number[n]["state"]) for n, _, _ in got]
    for r0, r1 in zip(rank0, rank1):
        if r0["state"] == "PRUNED":
            assert "seconds" not in r0 and "seconds" not in r1
            continue
        assert r0["value"] == by_number[r0["number"]]["value"]
        assert r0["results"] == r1["results"]
        assert r0["pruning_answers"] == r1["pruning_answers"] == [False] * pruning_epochs
        (run,) = _runs_by_trial(train["log_dir"])[r0["number"]]
        evald = _one_rank_rerun(name, train, tmp_path, r0, mode="eval", run_id=run.run_id,
                                log_dir=train["log_dir"])
        for ref in (_one_rank_rerun(name, train, tmp_path, r0), evald):
            assert r0["results"].keys() == ref.keys()
            if name == "pmgt":
                assert abs(r0["value"] - ref[criterion]) <= 1e-5
            else:
                assert r0["value"] == ref[criterion]
                for k in ("test/n20", "test/r20"):
                    assert r0["results"][k] == ref[k], k


def _runs_by_trial(log_dir):
    out = {}
    for run in RunRegistry(log_dir).list_runs():
        with open(os.path.join(run.run_dir, "tags.json")) as f:
            out.setdefault(int(json.load(f)["trial"]), []).append(run)
    return out


def test_pmgt_study_on_two_ranks_and_its_resume(tmp_path, data_dir, launches, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    argv, train = _configs(tmp_path, data_dir, "pmgt", num_devices=2)
    best = main(argv + ["--n-trials", "2"])
    trials_path = tmp_path / "hpo" / "pmgt-study_trials.json"
    first = json.loads(trials_path.read_text())
    assert [t["state"] for t in first] == ["COMPLETE"] * 2
    assert best == max(first, key=lambda t: t["value"])
    main(argv + ["--n-trials", "3"])
    stored = json.loads(trials_path.read_text())
    assert stored[:2] == first and [t["number"] for t in stored] == [0, 1, 2]
    assert len(launches) == 2 and [len(s) for s in launches] == [2, 2]
    assert [len(s[0]["trials"]) for s in launches] == [2, 1]  # the resume: one more
    runs = _runs_by_trial(train["log_dir"])  # one run a trial, written once
    assert {n: len(r) for n, r in runs.items()} == {0: 1, 1: 1, 2: 1}
    assert all(r.status == "FINISHED" for (r,) in runs.values())
    for study in launches:
        _check_study(study, stored, "pmgt", train, tmp_path, "test/auc", 0)


def test_ncf_study_prunes_on_every_rank(tmp_path, data_dir, launches, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    argv, train = _configs(tmp_path, data_dir, "ncf", num_devices=2)
    main(argv + ["--n-trials", "2", "--enable-trial-pruning"])
    stored = json.loads((tmp_path / "hpo" / "ncf-study_trials.json").read_text())
    complete = [t for t in stored if t["state"] == "COMPLETE"]
    pruned = [t for t in stored if t["state"] == "PRUNED"]
    assert len(complete) == 2 and all(t["params"]["factor_num"] == 8 for t in complete)
    assert all(t["params"]["factor_num"] == 4 for t in pruned)
    (study,) = launches
    assert sorted(_runs_by_trial(train["log_dir"])) == [t["number"] for t in complete]
    _check_study(study, stored, "ncf", train, tmp_path, "test/n20", 2)


def test_a_rank0_trial_that_prunes_stops_both_ranks_after_the_same_epoch(tmp_path, data_dir):
    _, train = _configs(tmp_path, data_dir, "ncf", num_epochs=4, factor_num=8)
    got = tmesh.launch(ranks.scripted_prune, 2, ("ncf", train, 1), device="cpu",
                       timeout_s=TIMEOUT, run_timeout_s=TIMEOUT, num_threads=1)
    assert [g["record"]["pruning_answers"] for g in got] == [[False, True]] * 2
    assert [step for _, step in got[0]["reports"]] == [0, 1] and got[1]["reports"] is None
    (run,) = RunRegistry(train["log_dir"]).list_runs()
    assert sorted({m["epoch"] for m in run.metrics() if m["name"] == "val/n20"}) == [0, 1]


def test_unset_num_devices_on_the_cpu_runs_one_rank_in_process(tmp_path, data_dir, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("no launch for one rank")

    monkeypatch.setattr(tmesh, "launch", refuse)
    argv, _ = _configs(tmp_path, data_dir, "ncf")
    best = main(argv + ["--n-trials", "1"])
    assert best["state"] == "COMPLETE"


@pytest.mark.parametrize("case", ["suggested_num_devices", "trio_in_the_config"])
def test_what_would_change_the_group_is_refused(tmp_path, data_dir, monkeypatch, case):
    def refuse(*a, **k):
        raise AssertionError("refused before any launch")

    monkeypatch.setattr(tmesh, "launch", refuse)
    if case == "trio_in_the_config":
        argv, train = _configs(tmp_path, data_dir, "ncf", num_devices=2,
                               coordinator_address="127.0.0.1:1", num_processes=2,
                               process_id=0)
        with pytest.raises(NotImplementedError, match="multi-host"):
            main(argv + ["--n-trials", "1"])
    else:
        argv, train = _configs(tmp_path, data_dir, "ncf")
        (tmp_path / "space.yaml").write_text(
            NCF_SPACE + "num_devices:\n  type: categorical\n  value: [1, 2]\n")
        with pytest.raises(ValueError, match="cannot suggest num_devices"):
            main(argv + ["--n-trials", "1"])
    assert not os.path.exists(train["log_dir"])
