"""The ``hp-tuning`` command (counterpart of ``pmgt_tpu/cli/hpo.py``):
hyperparameter search over the reference's conditional search-space DSL.

Search-space files are YAML (read by ``space_yaml``, the card machine has
no YAML package) or JSON mappings of parameter name → suggestion spec:

    lr: {type: float, value: [1.0e-4, 1.0e-2], step: null, round: 6}
    factor_num: {type: categorical, value: [16, 32, 64]}
    num_layers: {type: int, value: [1, 3]}
    model_name: {type: static, value: NeuMF-end}

Every spec may carry ``cond``: a list of conditions with ``cond_type`` in
{eq, neq, gt, gte, lt, lte, in, nin} comparing the suggested value against
``cond_value``; a matching condition either suggests the nested
``cond_param`` block or, with ``prune: true``, prunes the trial.

Backend: Optuna when it is importable (sqlite storage, its TPE and its
pruners); otherwise the built-in ``RandomSearchStudy`` (random bootstrap,
then TPE-style refinement) with JSON trial persistence. The built-in
trial's ``should_prune`` is always False, so without Optuna no trial is
pruned by its reported metrics, only by ``prune: true`` arms.

Each trial trains through ``cli.main.train_model`` with ``is_hptuning``:
its objective is ``test/<early_criterion>`` as ``test`` returns it, which
under HPO evaluates the validation split of the best checkpoint (the
reference's leakage guard). Trials build their ``TrainArgs`` as the
command line does (``cli.main.train_args``).

Every trial is data-parallel over the train config's ``num_devices``
ranks (unset: every visible card, one rank on the CPU), as the JAX
package's trials are over its mesh. The whole study is one launch
(``launch_study``; in this process for one rank). Rank 0 owns the study
(its storage, trial numbers and history: the built-in study seeds itself
from the clock, so ranks must not draw on their own), draws each trial's
parameters and broadcasts them, or the verdict of a ``prune: true`` arm;
every rank trains (``run_study``, which also runs inside a group a caller
has already started). With ``--enable-trial-pruning`` each rank's task
gets a ``RankTrial``: rank 0's ``should_prune`` is broadcast. The
multi-host trio in a trial config, and a ``num_devices`` the space
suggests, are refused. Each rank keeps a record of each trial: state,
value, seconds, pruning answers, kernel launches and the card's allocated
bytes after it; rank 0 also stores its value, results, seconds and
launches with the study's trial (the user attribute ``record``, which the
built-in study writes to its trials JSON).
"""
from __future__ import annotations

import argparse
import copy
import gc
import json
import logging
import os
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from pmgt_tpu_torch.cli.main import (
    MULTI_HOST,
    _existing_path,
    configure_logging,
    log_elapsed_time,
    train_args,
    train_model,
    visible_devices,
)
from pmgt_tpu_torch.core import mesh as dist_mesh
from pmgt_tpu_torch.core.mesh import broadcast_object, current_mesh
from pmgt_tpu_torch.ops.dual_attention import launch_counts

logger = logging.getLogger("pmgt_tpu_torch")

try:
    import optuna

    HAVE_OPTUNA = True

    class TrialPruned(optuna.TrialPruned):
        pass

except ImportError:  # no optuna: the built-in study
    optuna = None
    HAVE_OPTUNA = False

    class TrialPruned(Exception):
        pass


# --------------------------------------------------------------------------
# conditional search-space DSL
# --------------------------------------------------------------------------

def _suggest_value(trial, key: str, spec: Dict[str, Any]) -> Any:
    t = spec["type"]
    if t == "categorical":
        return trial.suggest_categorical(key, spec["value"])
    if t == "float":
        v = trial.suggest_float(key, *spec["value"], step=spec.get("step"))
        return round(v, spec["round"]) if "round" in spec else v
    if t == "int":
        return trial.suggest_int(key, *spec["value"])
    if t == "static":
        return spec["value"]
    raise ValueError(f"unknown suggestion type {t!r} for {key!r}")


_COND_OPS = {
    "eq": lambda a, b: a == b,
    "neq": lambda a, b: a != b,
    "gt": lambda a, b: a > b,
    "gte": lambda a, b: a >= b,
    "lt": lambda a, b: a < b,
    "lte": lambda a, b: a <= b,
    "in": lambda a, b: a in b,
    "nin": lambda a, b: a not in b,
}


def get_hp_params(trial, hp_params: Dict[str, Any]) -> Dict[str, Any]:
    """Resolve the search space for one trial, applying conditions
    recursively."""
    resolved: Dict[str, Any] = {}
    for key, spec in hp_params.items():
        resolved[key] = _suggest_value(trial, key, spec)
        for cond in spec.get("cond", []):
            op = _COND_OPS[cond["cond_type"]]
            if op(resolved[key], cond["cond_value"]):
                if cond.get("prune"):
                    raise TrialPruned()
                if "cond_param" in cond:
                    resolved.update(get_hp_params(trial, cond["cond_param"]))
    return resolved


# --------------------------------------------------------------------------
# the built-in search backend: random bootstrap + TPE-style refinement
# --------------------------------------------------------------------------

def _tpe_numeric(history, low, high, rng, n_candidates=24, gamma=0.3):
    """A value by the TPE density ratio l(x)/g(x): the top-γ trials'
    values ("good") and the rest ("bad") as Gaussian kernel mixtures,
    candidates drawn from the good mixture, the best ratio kept.
    history: [(value, objective)] sorted best-first."""
    values = np.asarray([v for v, _ in history], dtype=np.float64)
    n_good = max(1, int(np.ceil(gamma * len(values))))
    good, bad = values[:n_good], values[n_good:]
    if len(bad) == 0:
        bad = values
    span = max(high - low, 1e-12)

    def bw(xs):
        return max(np.std(xs) * len(xs) ** -0.2, 0.05 * span)

    bw_g, bw_b = bw(good), bw(bad)

    def density(x, centers, h):
        z = (x[:, None] - centers[None, :]) / h
        return np.exp(-0.5 * z * z).sum(axis=1) / (len(centers) * h) + 1e-12

    centers = good[rng.integers(len(good), size=n_candidates)]
    cands = np.clip(centers + rng.normal(size=n_candidates) * bw_g, low, high)
    ratio = density(cands, good, bw_g) / density(cands, bad, bw_b)
    return float(cands[int(np.argmax(ratio))])


def _tpe_categorical(history, choices, rng, gamma=0.3):
    """A draw from the smoothed empirical distribution of the top-γ
    trials' choices."""
    n_good = max(1, int(np.ceil(gamma * len(history))))
    good = [v for v, _ in history[:n_good]]
    weights = np.ones(len(choices))  # Laplace smoothing
    for v in good:
        for i, c in enumerate(choices):
            if c == v:
                weights[i] += 1.0
    weights = weights / weights.sum()
    return choices[int(rng.choice(len(choices), p=weights))]


class RandomTrial:
    """One trial of the built-in study. Random suggestions until
    ``history`` (best-first [(params, value)]) holds ``MIN_HISTORY``
    completed trials with the parameter, TPE-style ones after."""

    MIN_HISTORY = 8

    def __init__(self, number: int, rng: np.random.Generator, history=None):
        self.number = number
        self.params: Dict[str, Any] = {}
        self._rng = rng
        self._history = history or []
        self.value: Optional[float] = None
        self.state = "RUNNING"
        self.user_attrs: Dict[str, Any] = {}

    def _param_history(self, name):
        return [
            (p[name], v) for p, v in self._history if name in p
        ]

    def suggest_categorical(self, name, choices):
        hist = self._param_history(name)
        if len(hist) >= self.MIN_HISTORY:
            v = _tpe_categorical(hist, list(choices), self._rng)
        else:
            v = choices[int(self._rng.integers(len(choices)))]
        self.params[name] = v
        return v

    def suggest_float(self, name, low, high, step=None, log=False):
        hist = self._param_history(name)
        if len(hist) >= self.MIN_HISTORY:
            v = _tpe_numeric(hist, low, high, self._rng)
            if step:
                v = low + round((v - low) / step) * step
            v = float(min(max(v, low), high))
        elif step:
            n = int((high - low) / step) + 1
            v = low + step * int(self._rng.integers(n))
        elif log:
            v = float(np.exp(self._rng.uniform(np.log(low), np.log(high))))
        else:
            v = float(self._rng.uniform(low, high))
        self.params[name] = v
        return v

    def suggest_int(self, name, low, high, step=1):
        hist = self._param_history(name)
        if len(hist) >= self.MIN_HISTORY:
            v = int(round(_tpe_numeric(hist, low, high, self._rng)))
            v = min(max(v, low), high)
        else:
            v = int(self._rng.integers(low, high + 1))
        self.params[name] = v
        return v

    def report(self, value, step):  # no pruner in the built-in study
        pass

    def set_user_attr(self, key, value):
        """Optuna's trial attribute: stored with the trial in the trials
        JSON."""
        self.user_attrs[key] = value

    def should_prune(self):
        return False


class RandomSearchStudy:
    """The built-in study: trials persisted as JSON in
    ``<dir(storage_path)>/<study_name>_trials.json``, resumed from it."""

    def __init__(
        self,
        storage_path: str,
        study_name: str,
        direction: str,
        seed: Optional[int] = None,
    ):
        self.direction = direction
        self.seed = seed
        self.path = os.path.join(
            os.path.dirname(storage_path), f"{study_name}_trials.json"
        )
        self.trials = []
        if os.path.exists(self.path):
            with open(self.path, encoding="utf-8") as f:
                self.trials = json.load(f)

    def _history(self):
        """Completed trials as best-first [(params, value)]."""
        done = [t for t in self.trials if t["state"] == "COMPLETE"]
        reverse = self.direction == "maximize"
        done.sort(key=lambda t: t["value"], reverse=reverse)
        return [(t["params"], t["value"]) for t in done]

    def optimize(
        self, objective, n_trials: int, callbacks=(), max_total_trials=None
    ):
        """Run until ``n_trials`` COMPLETE trials exist. PRUNED trials do
        not count toward the target but do count toward a total-attempt
        cap (default: 10·n_trials, at least n_trials + 20), so an
        always-pruning space cannot loop forever."""
        if max_total_trials is None:
            max_total_trials = max(10 * n_trials, n_trials + 20)
        base = (
            self.seed
            if self.seed is not None
            else int(time.time()) % 1000
        )
        rng = np.random.default_rng(len(self.trials) * 7919 + base)
        while len([t for t in self.trials if t["state"] == "COMPLETE"]) < n_trials:
            if len(self.trials) >= max_total_trials:
                logger.warning(
                    "stopping after %d total trials (%d COMPLETE < %d "
                    "requested): search space prunes too aggressively",
                    len(self.trials),
                    len([t for t in self.trials if t["state"] == "COMPLETE"]),
                    n_trials,
                )
                break
            trial = RandomTrial(len(self.trials), rng, history=self._history())
            try:
                value = objective(trial)
                record = {
                    "number": trial.number,
                    "params": trial.params,
                    "value": float(value),
                    "state": "COMPLETE",
                }
            except TrialPruned:
                record = {
                    "number": trial.number,
                    "params": trial.params,
                    "value": None,
                    "state": "PRUNED",
                }
            if trial.user_attrs:
                record["user_attrs"] = trial.user_attrs
            self.trials.append(record)
            with open(self.path, "w", encoding="utf-8") as f:
                json.dump(self.trials, f, indent=2)

    @property
    def best_trial(self):
        done = [t for t in self.trials if t["state"] == "COMPLETE"]
        if not done:
            raise ValueError("no completed trials (all pruned or none run)")
        reverse = self.direction == "maximize"
        return sorted(done, key=lambda t: t["value"], reverse=reverse)[0]


# --------------------------------------------------------------------------
# the study over a data-parallel group: trials led by rank 0
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class StudySpec:
    """What every rank of a study needs: the search space, the trials'
    train config, the study's settings and the device."""

    train_name: str
    train_params: Dict[str, Any]
    hp_params: Dict[str, Any]
    n_trials: int
    study_name: str
    storage_path: str
    enable_trial_pruning: bool = False
    device: str = "cuda"

    @property
    def criterion(self) -> str:
        return "test/" + self.train_params.get("early_criterion", "loss")

    @property
    def direction(self) -> str:
        return "minimize" if self.train_params.get("early_criterion") == "loss" else "maximize"


def _check_world(params: Dict[str, Any], suggested: Dict[str, Any]) -> None:
    """Refuse what would change a trial's group: the multi-host trio (a
    study is one host's, as in the JAX package, which never joins hosts
    for one) and a ``num_devices`` that the space suggests (the ranks are
    fixed when the study is launched)."""
    trio = sorted(k for k in MULTI_HOST if params.get(k) is not None)
    if trio:
        raise NotImplementedError(
            f"hp-tuning runs on one host; the multi-host options {trio} are refused in a "
            "trial config (set num_devices for data-parallel trials)")
    if "num_devices" in suggested:
        raise ValueError("a search space cannot suggest num_devices: a study's ranks are "
                         "fixed at launch (set num_devices in the train config)")


class RankTrial:
    """A trial as one rank's task sees it. On rank 0 it wraps the study's
    trial: ``report`` reports to it and ``should_prune`` broadcasts its
    decision. On the other ranks ``report`` does nothing and
    ``should_prune`` returns rank 0's decision. Every rank of a trial has
    one exactly when pruning is enabled, so the engine asks on every rank
    after the same epoch; ``answers`` lists the decisions."""

    def __init__(self, mesh, trial=None):
        self.mesh, self.trial = mesh, trial
        self.answers: List[bool] = []

    def report(self, value, step):
        if self.trial is not None:
            self.trial.report(value, step)

    def should_prune(self) -> bool:
        mine = bool(self.trial.should_prune()) if self.trial is not None else None
        self.answers.append(bool(broadcast_object(self.mesh, mine)))
        return self.answers[-1]


def _allocated(device: str) -> Optional[int]:
    """The card's allocated bytes after a garbage collection (None on the
    CPU)."""
    gc.collect()
    if torch.device(device).type != "cuda":
        return None
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def _train_trial(msg: Dict[str, Any], train_name: str, criterion: str, pruning: bool,
                 device: str, mesh, trial, records: list) -> float:
    """Train rank 0's trial ``msg`` on this rank; its ``criterion`` is the
    value. Appends this rank's record of it to ``records``: state, value,
    test results, seconds, pruning answers, kernel launches, and the card's
    allocated bytes after it."""
    rank_trial = RankTrial(mesh, trial) if pruning else None
    before = launch_counts()
    t = time.perf_counter()
    results = train_model(train_name, train_args(msg["params"]), device=device,
                          is_hptuning=True, trial=rank_trial, enable_trial_pruning=pruning)
    value = results.get(criterion, 0)
    after = launch_counts()
    rec = {
        "number": msg["number"], "params": msg["suggested"], "state": "COMPLETE",
        "value": float(value), "results": results, "seconds": time.perf_counter() - t,
        "pruning_answers": rank_trial.answers if rank_trial else [],
        "launches": {k: after[k] - before[k] for k in after},
        "memory_allocated": _allocated(device)}
    records.append(rec)
    return value


def _objective(
    trial,
    train_params: Dict[str, Any],
    hp_params: Dict[str, Any],
    train_name: str,
    criterion: str,
    enable_trial_pruning: bool,
    device: str = "cuda",
    records: Optional[list] = None,
) -> float:
    """One trial, led by this process (rank 0 of its group, or alone):
    the suggestions, broadcast to the other ranks with the trial's
    parameters (or, when a ``prune: true`` arm raised ``TrialPruned``,
    the verdict, and no rank trains), then the training on every rank.
    Appends this rank's record of the trial to ``records``."""
    mesh = current_mesh(device)
    records = [] if records is None else records
    try:
        suggested = get_hp_params(trial, hp_params)
    except TrialPruned:
        msg = {"number": trial.number, "suggested": dict(trial.params), "pruned": True}
        broadcast_object(mesh, msg)
        _pruned(msg, records)
        raise
    params = {**copy.deepcopy(train_params), **suggested}
    _check_world(params, suggested)
    tags = [tuple(t) for t in params.get("tags", [])]
    tags.append(("trial", str(trial.number)))
    params["tags"] = tags
    msg = broadcast_object(mesh, {"number": trial.number, "params": params,
                                  "suggested": dict(trial.params)})
    return _train_trial(msg, train_name, criterion, enable_trial_pruning, device, mesh, trial,
                        records)


def _pruned(msg: Dict[str, Any], records: list) -> None:
    records.append({"number": msg["number"], "params": msg["suggested"], "state": "PRUNED",
                    "value": None})


def _follow(spec: StudySpec, mesh, records: list) -> None:
    """A rank other than 0: train each trial rank 0 broadcasts until it
    broadcasts the stop (None)."""
    while True:
        msg = broadcast_object(mesh, None)
        if msg is None:
            return
        if msg.get("pruned"):
            _pruned(msg, records)
            continue
        _train_trial(msg, spec.train_name, spec.criterion, spec.enable_trial_pruning,
                     spec.device, mesh, None, records)


def run_study(spec: StudySpec) -> Dict[str, Any]:
    """The study inside this process's group (or alone): rank 0 owns the
    study (the built-in one or Optuna's, its storage, its trial numbers
    and history), draws each trial's parameters and broadcasts them;
    every rank trains every trial. When rank 0's ``optimize`` returns
    (trial target, attempt cap, ``study.stop()`` or ``KeyboardInterrupt``)
    it broadcasts the stop. A trial that fails raises on its rank.
    Returns ``{"best": the best trial (rank 0; None on the others),
    "trials": this rank's trial records}``."""
    mesh = current_mesh(spec.device)
    records: List[Dict[str, Any]] = []
    if not mesh.is_primary:
        _follow(spec, mesh, records)
        return {"best": None, "trials": records}

    def objective(trial):
        value = _objective(trial, spec.train_params, spec.hp_params, spec.train_name,
                           spec.criterion, spec.enable_trial_pruning, spec.device, records)
        # the study stores the trained trial's record with it
        trial.set_user_attr("record", {k: records[-1][k] for k in ("value", "results",
                                                                    "seconds", "launches")})
        return value

    n_trials = spec.n_trials
    if HAVE_OPTUNA:
        study = optuna.create_study(
            study_name=spec.study_name,
            storage=f"sqlite:///{spec.storage_path}",
            load_if_exists=True,
            direction=spec.direction,
        )

        def max_trial_callback(study, trial):
            states = (
                optuna.trial.TrialState.COMPLETE,
                optuna.trial.TrialState.RUNNING,
            )
            if len([t for t in study.trials if t.state in states]) >= n_trials:
                study.stop()
            # The built-in study's backstop: PRUNED trials count toward a
            # hard total-attempt cap.
            if len(study.trials) >= max(10 * n_trials, n_trials + 20):
                logger.warning(
                    "stopping after %d total trials: search space prunes "
                    "too aggressively",
                    len(study.trials),
                )
                study.stop()

        try:
            study.optimize(objective, callbacks=[max_trial_callback])
        except KeyboardInterrupt:
            logger.info("Stop tuning.")
        broadcast_object(mesh, None)
        best = study.best_trial
        number, value, params = best.number, best.value, best.params
    else:
        logger.warning("optuna not installed — using built-in random search")
        study = RandomSearchStudy(spec.storage_path, spec.study_name, spec.direction)
        try:
            study.optimize(objective, n_trials=n_trials)
        except KeyboardInterrupt:
            logger.info("Stop tuning.")
        broadcast_object(mesh, None)
        best = study.best_trial
        number, value, params = best["number"], best["value"], best["params"]
    logger.info("best_exp_num: %s", number)
    logger.info("best_score: %s", value)
    logger.info("best_params: %s", params)
    return {"best": best, "trials": records}


def _study_rank_main(spec: StudySpec) -> Dict[str, Any]:
    configure_logging()
    return run_study(spec)


def launch_study(spec: StudySpec) -> List[Dict[str, Any]]:
    """Run the study on ``num_devices`` ranks of the train config (unset:
    every visible card, one rank on the CPU, as ``train-pmgt`` resolves
    it): in this process for one rank, else in one launch of that many
    processes for the whole study. Returns each rank's ``run_study``
    result, in rank order."""
    _check_world(spec.train_params, {})
    n = spec.train_params.get("num_devices")
    ranks = n if n is not None else visible_devices(spec.device)
    if ranks == 1:
        return [run_study(spec)]
    return dist_mesh.launch(_study_rank_main, ranks, (spec,), device=spec.device)


def _load_space(path: str) -> Dict[str, Any]:
    text = Path(path).read_text(encoding="utf-8")
    if path.endswith(".json"):
        return json.loads(text)
    from pmgt_tpu_torch.cli import space_yaml

    return space_yaml.load(text)


def add_hp_tuning(sub) -> None:
    p = sub.add_parser("hp-tuning", help="hyperparameter tuning",
                       formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    a = p.add_argument
    a("--hp-config-path", type=_existing_path, required=True)
    a("--train-config-path", type=_existing_path, required=True)
    a("--n-trials", type=int, default=20)
    a("--study-name", default="study")
    a("--storage-path", default="./outputs/hpo_storage.db")
    a("--train-name", choices=("ncf", "dcn", "pmgt", "pmgt_ncf"), default="ncf")
    a("--enable-trial-pruning", action="store_true")
    p.set_defaults(handler=hp_tuning)


def study_spec(ns: argparse.Namespace) -> StudySpec:
    """The study of an ``hp-tuning`` command line; creates the storage
    directory."""
    hp_params = _load_space(ns.hp_config_path)
    with open(ns.train_config_path, encoding="utf-8") as f:
        train_params = json.load(f)
    storage_path = os.path.abspath(ns.storage_path)
    os.makedirs(os.path.dirname(storage_path), exist_ok=True)
    train_params["tags"] = list(train_params.get("tags", [])) + [["study_name", ns.study_name]]
    return StudySpec(ns.train_name, train_params, hp_params, ns.n_trials, ns.study_name,
                     storage_path, ns.enable_trial_pruning, ns.device)


@log_elapsed_time
def hp_tuning(ns: argparse.Namespace):
    """Run the study; returns its best trial (the built-in study's record,
    or Optuna's ``FrozenTrial``)."""
    return launch_study(study_spec(ns))[0]["best"]
