"""The port's ``hp-tuning`` (``pmgt_tpu_torch/cli/hpo.py``) against the JAX
package's (``pmgt_tpu/cli/hpo.py``), and its trial plumbing.

- For every ``config/hpo/*.yaml`` (each package reading it its own way:
  the port with ``space_yaml``, JAX with PyYAML), 20 trials of
  ``get_hp_params`` under ``RandomTrial(i, default_rng(s), history)`` give
  equal params and equal ``TrialPruned`` outcomes in both packages, with a
  growing history, so past ``MIN_HISTORY`` the TPE suggestions are
  compared too.
- ``RandomSearchStudy`` of both packages, on one seed and a scripted
  objective, writes the same trials JSON: a run, a resumed run, an
  always-pruning space stopped at the attempt cap.
- The Optuna branch, with the fake optuna module of
  ``tests/test_hpo_optuna_branch.py`` (copied): the command runs real
  trials through it.
- ``hp-tuning`` end to end with ``--device cpu`` on a tiny synthetic
  dataset for ``--train-name pmgt`` (hidden 16 or 32, 1 epoch) and
  ``ncf``: each COMPLETE trial is a FINISHED run tagged ``trial`` and
  ``study_name``; its objective is ``test/<criterion>`` as ``test(...,
  is_hptuning=True)`` returns it, the validation split relabelled, equal
  to the run's logged ``val/<criterion>``; a resumed study adds exactly
  the missing trials.
- ``should_prune`` with a scripted trial stops ``fit`` at that epoch, in
  PMGT and NCF; without ``enable_trial_pruning`` the task gets no trial.
"""
import glob
import importlib
import json
import os
import sys
import types
import zlib

import numpy as np
import pytest

from pmgt_tpu.cli import hpo as jhpo
from pmgt_tpu_torch.cli import hpo as thpo
from pmgt_tpu_torch.cli.main import main, train_args, train_model
from pmgt_tpu_torch.data.artifacts import save_native
from pmgt_tpu_torch.data.synthetic import make_synthetic_dataset
from pmgt_tpu_torch.train.registry import RunRegistry

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "config", "hpo")
YAMLS = sorted(glob.glob(os.path.join(CONFIG_DIR, "*.yaml")))


def _scripted_value(params):
    """A deterministic objective of a trial's params."""
    return float(sum(zlib.crc32(str(k).encode()) % 97 * 0.01
                     + (v if isinstance(v, (int, float)) else 0.3)
                     for k, v in sorted(params.items())) % 1.0)


def _resolve_trials(pkg, space, seed, n=20):
    rng = np.random.default_rng(seed)
    done, out = [], []
    for i in range(n):
        history = sorted(done, key=lambda pv: -pv[1])
        trial = pkg.RandomTrial(i, rng, history=history)
        try:
            resolved = pkg.get_hp_params(trial, space)
        except pkg.TrialPruned:
            out.append(("PRUNED", dict(trial.params)))
            continue
        done.append((dict(trial.params), _scripted_value(trial.params)))
        out.append(("COMPLETE", resolved))
    return out, done


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("path", YAMLS, ids=os.path.basename)
def test_trials_resolve_alike_on_every_space(path, seed):
    tspace, jspace = thpo._load_space(path), jhpo._load_space(path)
    assert tspace == jspace
    t, done = _resolve_trials(thpo, tspace, seed)
    j, _ = _resolve_trials(jhpo, jspace, seed)
    assert t == j
    assert any(state == "COMPLETE" for state, _ in t)


def test_tpe_takes_over_past_min_history():
    """On the PMGT space (no prune arms) trials 8.. draw from the history:
    the same rng gives other values without it."""
    path = os.path.join(CONFIG_DIR, "hpo_pmgt_params.yaml")
    space = thpo._load_space(path)
    with_history, done = _resolve_trials(thpo, space, 0)
    assert len(done) == 20 and thpo.RandomTrial.MIN_HISTORY == 8
    rng = np.random.default_rng(0)
    without = [thpo.get_hp_params(thpo.RandomTrial(i, rng), space) for i in range(20)]
    assert with_history[:8] == [("COMPLETE", p) for p in without[:8]]
    assert with_history[8:] != [("COMPLETE", p) for p in without[8:]]


def _study_json(pkg, tmp_path, name, runs, objective, seed=7):
    storage = str(tmp_path / pkg.__name__ / "storage.db")
    os.makedirs(os.path.dirname(storage), exist_ok=True)
    for n_trials in runs:
        study = pkg.RandomSearchStudy(storage, name, "maximize", seed=seed)
        study.optimize(lambda trial: objective(pkg, trial), n_trials=n_trials)
    with open(study.path) as f:
        return json.load(f), study


def _mixed_objective(pkg, trial):
    kind = trial.suggest_categorical("kind", ["a", "b", "c"])
    x = trial.suggest_float("x", 0.0, 1.0)
    k = trial.suggest_int("k", 1, 6)
    s = trial.suggest_float("s", 0.1, 0.5, step=0.1)
    if kind == "c" and x < 0.3:
        raise pkg.TrialPruned()
    return -((x - 0.7) ** 2) + 0.01 * k + s + (kind == "a")


def test_random_search_study_writes_the_same_trials_json(tmp_path):
    t, tstudy = _study_json(thpo, tmp_path, "s", [12], _mixed_objective)
    j, jstudy = _study_json(jhpo, tmp_path, "s", [12], _mixed_objective)
    assert t == j
    assert len([r for r in t if r["state"] == "COMPLETE"]) == 12
    assert tstudy.best_trial == jstudy.best_trial


def test_trial_user_attrs_are_stored_with_the_trial(tmp_path):
    # hp-tuning stores each trained trial's record this way (Optuna's
    # ``set_user_attr``); a trial that sets none is stored as the JAX
    # package's built-in study stores it
    def objective(pkg, trial):
        value = _mixed_objective(pkg, trial)
        if trial.number % 2:
            trial.set_user_attr("record", {"value": value, "launches": {"k1": trial.number}})
        return value

    t, _ = _study_json(thpo, tmp_path, "u", [6], objective)
    j, _ = _study_json(jhpo, tmp_path, "u", [6], _mixed_objective)
    for rec, ref in zip(t, j):
        attrs = rec.pop("user_attrs", None)
        assert rec == ref
        if rec["number"] % 2 and rec["state"] == "COMPLETE":
            assert attrs == {"record": {"value": rec["value"], "launches": {"k1": rec["number"]}}}
        else:
            assert attrs is None


def test_resumed_study_adds_exactly_the_missing_trials(tmp_path):
    t, _ = _study_json(thpo, tmp_path, "r", [4, 9], _mixed_objective)
    j, _ = _study_json(jhpo, tmp_path, "r", [4, 9], _mixed_objective)
    assert t == j
    assert len([r for r in t if r["state"] == "COMPLETE"]) == 9
    assert [r["number"] for r in t] == list(range(len(t)))


def test_always_pruning_space_stops_at_the_cap(tmp_path):
    space = {"x": {"type": "static", "value": 10,
                   "cond": [{"cond_type": "gte", "cond_value": 5, "prune": True}]}}

    def objective(pkg, trial):
        pkg.get_hp_params(trial, space)
        return 0.0

    t, study = _study_json(thpo, tmp_path, "p", [4], objective)
    j, _ = _study_json(jhpo, tmp_path, "p", [4], objective)
    assert t == j and len(t) == 40 and all(r["state"] == "PRUNED" for r in t)
    with pytest.raises(ValueError, match="no completed trials"):
        study.best_trial


# ---- end to end on the CPU --------------------------------------------------

@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("hpo_data")
    art = make_synthetic_dataset(num_nodes=90, num_users=40, feat_dims=(12, 8),
                                 avg_degree=5, interactions_per_user=8, seed=0)
    save_native(str(d / "S"), art)
    return str(d)


PMGT_SPACE = """\
lr:
  type: float
  value: [1.0e-4, 1.0e-2]
  round: 6
hidden_size:
  type: categorical
  value: [16, 32]
  cond:
    - cond_type: eq
      cond_value: 16
      cond_param:
        intermediate_size:
          type: static
          value: 16
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


def _configs(tmp_path, data_dir, name):
    if name == "pmgt":
        space, train = PMGT_SPACE, {
            "model_name": "PMGT", "early_criterion": "auc", "train_batch_size": 16,
            "test_batch_size": 32, "num_hidden_layers": 2, "intermediate_size": 32,
            "hop_sampling_sizes": [4, 2], "mp_enabled": False}
    else:
        space, train = NCF_SPACE, {
            "model_name": "NeuMF-end", "early_criterion": "n20", "train_batch_size": 32,
            "test_batch_size": 32, "num_layers": 2, "max_sample_items": 20,
            "num_workers": 8, "scheduler_type": None, "run_name": "ncf-hpo"}
    train.update(dataset_name="S", data_dir=data_dir, log_dir=str(tmp_path / "logs"),
                 num_epochs=1, experiment_name=f"hpo-{name}", seed=0, tags=[["team", "x"]])
    (tmp_path / "space.yaml").write_text(space)
    (tmp_path / "train.json").write_text(json.dumps(train))
    return ["--device", "cpu", "hp-tuning", "--hp-config-path", str(tmp_path / "space.yaml"),
            "--train-config-path", str(tmp_path / "train.json"), "--train-name", name,
            "--study-name", f"{name}-study", "--storage-path", str(tmp_path / "hpo" / "db")]


@pytest.mark.parametrize("name,criterion", [("pmgt", "auc"), ("ncf", "n20")])
def test_hp_tuning_end_to_end_and_resume(tmp_path, data_dir, name, criterion):
    argv = _configs(tmp_path, data_dir, name)
    best = main(argv + ["--n-trials", "2"])
    trials_path = tmp_path / "hpo" / f"{name}-study_trials.json"
    first = json.loads(trials_path.read_text())
    assert len([t for t in first if t["state"] == "COMPLETE"]) == 2
    main(argv + ["--n-trials", "3"])
    trials = json.loads(trials_path.read_text())
    assert trials[: len(first)] == first
    complete = [t for t in trials if t["state"] == "COMPLETE"]
    assert len(complete) == 3 and trials[len(first):][-1]["state"] == "COMPLETE"
    assert best == max(complete[:2], key=lambda t: t["value"])
    if name == "ncf":
        assert all(t["params"]["factor_num"] == 8 for t in complete)
        assert all(t["params"]["factor_num"] == 4 for t in trials if t["state"] == "PRUNED")

    runs = {}
    for run in RunRegistry(str(tmp_path / "logs")).list_runs():
        with open(os.path.join(run.run_dir, "tags.json")) as f:
            tags = json.load(f)
        runs[int(tags["trial"])] = (run, tags)
    assert sorted(runs) == [t["number"] for t in complete]
    for t in complete:
        run, tags = runs[t["number"]]
        assert run.status == "FINISHED"
        assert tags["study_name"] == f"{name}-study" and tags["team"] == "x"
        logged = [m["value"] for m in run.metrics() if m["name"] == f"val/{criterion}"]
        assert len(logged) == 1 and t["value"] == logged[0]
        for key, value in t["params"].items():
            if key != "lr":  # the space rounds lr after the draw
                assert run.params[key] == value


@pytest.mark.parametrize("name,criterion", [("pmgt", "auc"), ("ncf", "n20")])
def test_hptuning_test_is_the_validation_split_relabelled(tmp_path, data_dir, name, criterion):
    argv = _configs(tmp_path, data_dir, name)
    params = json.loads((tmp_path / "train.json").read_text())
    params.update(factor_num=8, hidden_size=16, intermediate_size=16)
    args = train_args(params)
    out = train_model(name, args, device="cpu", is_hptuning=True)
    assert sorted(out) == sorted(k.replace("val/", "test/") for k in out)
    (run,) = RunRegistry(args.log_dir).list_runs()
    logged = {m["name"]: m["value"] for m in run.metrics() if m["name"].startswith("val/")}
    assert out == {k.replace("val/", "test/"): v for k, v in logged.items()}
    test_out = train_model(name, train_args({**params, "log_dir": str(tmp_path / "l2")}),
                           device="cpu")
    assert f"test/{criterion}" in test_out and test_out != out
    assert argv  # the configs were written


class _ScriptedTrial:
    """Prunes at ``prune_at``; records what it was told."""

    def __init__(self, prune_at):
        self.prune_at, self.reports = prune_at, []

    def report(self, value, step):
        self.reports.append((value, step))

    def should_prune(self):
        return self.reports[-1][1] >= self.prune_at


@pytest.mark.parametrize("name,criterion", [("pmgt", "auc"), ("ncf", "n20")])
def test_should_prune_stops_fit_at_that_epoch(tmp_path, data_dir, name, criterion):
    _configs(tmp_path, data_dir, name)
    params = json.loads((tmp_path / "train.json").read_text())
    params.update(num_epochs=4, early=0, factor_num=8)
    trial = _ScriptedTrial(prune_at=1)
    train_model(name, train_args(params), device="cpu", is_hptuning=True, trial=trial,
                enable_trial_pruning=True)
    assert [step for _, step in trial.reports] == [0, 1]
    (run,) = RunRegistry(params["log_dir"]).list_runs()
    logged = [(m["value"], m["epoch"]) for m in run.metrics() if m["name"] == f"val/{criterion}"]
    assert logged == trial.reports
    # without enable_trial_pruning the task never sees the trial
    quiet = _ScriptedTrial(prune_at=0)
    train_model(name, train_args({**params, "num_epochs": 2,
                                  "log_dir": str(tmp_path / "quiet")}),
                device="cpu", is_hptuning=True, trial=quiet)
    assert quiet.reports == []


def test_multi_host_options_refused_in_a_trial(tmp_path, data_dir):
    _configs(tmp_path, data_dir, "ncf")
    params = json.loads((tmp_path / "train.json").read_text())
    with pytest.raises(NotImplementedError, match="multi-host"):
        thpo._objective(thpo.RandomTrial(0, np.random.default_rng(0)),
                        {**params, "num_processes": 2}, {}, "ncf", "test/n20", False, "cpu")


# ---- the Optuna branch (optuna is not installed: a fake module) --------------

def _make_fake_optuna():
    """The fake optuna of ``tests/test_hpo_optuna_branch.py``: the API
    surface the command uses."""
    optuna = types.ModuleType("optuna")

    class TrialPruned(Exception):
        pass

    class TrialState:
        COMPLETE = "COMPLETE"
        RUNNING = "RUNNING"
        PRUNED = "PRUNED"

    class _Trial:
        def __init__(self, number, rng):
            self.number = number
            self.params = {}
            self.state = TrialState.RUNNING
            self.value = None
            self.user_attrs = {}
            self._rng = rng

        def set_user_attr(self, key, value):
            self.user_attrs[key] = value

        def suggest_categorical(self, name, choices):
            v = choices[int(self._rng.integers(len(choices)))]
            self.params[name] = v
            return v

        def suggest_float(self, name, low, high, step=None, log=False):
            if step:
                n = int((high - low) / step) + 1
                v = low + step * int(self._rng.integers(n))
            else:
                v = float(self._rng.uniform(low, high))
            self.params[name] = v
            return v

        def suggest_int(self, name, low, high):
            v = int(self._rng.integers(low, high + 1))
            self.params[name] = v
            return v

        def report(self, value, step):
            pass

        def should_prune(self):
            return False

    class _Study:
        def __init__(self, study_name, storage, direction):
            self.study_name = study_name
            self.storage = storage
            self.direction = direction
            self.trials = []
            self._stopped = False
            self._rng = np.random.default_rng(0)

        def optimize(self, objective, callbacks=()):
            while not self._stopped:
                t = _Trial(len(self.trials), self._rng)
                self.trials.append(t)
                try:
                    t.value = float(objective(t))
                    t.state = TrialState.COMPLETE
                except TrialPruned:
                    t.state = TrialState.PRUNED
                for cb in callbacks:
                    cb(self, t)

        def stop(self):
            self._stopped = True

        @property
        def best_trial(self):
            done = [t for t in self.trials if t.state == TrialState.COMPLETE]
            return max(
                done,
                key=lambda t: t.value if self.direction == "maximize" else -t.value,
            )

    created = {}

    def create_study(study_name, storage, load_if_exists, direction):
        created["args"] = dict(
            study_name=study_name,
            storage=storage,
            load_if_exists=load_if_exists,
            direction=direction,
        )
        study = _Study(study_name, storage, direction)
        created["study"] = study
        return study

    optuna.TrialPruned = TrialPruned
    optuna.create_study = create_study
    optuna.trial = types.SimpleNamespace(TrialState=TrialState)
    optuna._created = created
    return optuna


@pytest.fixture
def fake_optuna(monkeypatch):
    fake = _make_fake_optuna()
    monkeypatch.setitem(sys.modules, "optuna", fake)
    importlib.reload(thpo)
    assert thpo.HAVE_OPTUNA
    yield fake
    monkeypatch.delitem(sys.modules, "optuna", raising=False)
    sys.modules.pop("optuna", None)
    importlib.reload(thpo)
    assert not thpo.HAVE_OPTUNA


def test_optuna_branch_runs_trials_end_to_end(tmp_path, data_dir, fake_optuna):
    argv = _configs(tmp_path, data_dir, "ncf")
    best = main(argv + ["--n-trials", "2"])
    args = fake_optuna._created["args"]
    assert args["storage"] == "sqlite:///" + str(tmp_path / "hpo" / "db")
    assert args["direction"] == "maximize" and args["load_if_exists"] is True
    study = fake_optuna._created["study"]
    states = [t.state for t in study.trials]
    assert states.count("COMPLETE") >= 1 and study._stopped
    assert all(t.params["factor_num"] == 8 for t in study.trials if t.state == "COMPLETE")
    assert all(t.params["factor_num"] == 4 for t in study.trials if t.state == "PRUNED")
    assert best is study.best_trial and best.value is not None
    # each trained trial's record is stored with it
    assert all(t.user_attrs["record"]["value"] == t.value
               for t in study.trials if t.state == "COMPLETE")
    # a prune arm raises the port's TrialPruned, an optuna.TrialPruned
    assert issubclass(thpo.TrialPruned, fake_optuna.TrialPruned)
