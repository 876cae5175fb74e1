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
"""
from __future__ import annotations

import argparse
import copy
import json
import logging
import os
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from pmgt_tpu_torch.cli.main import (
    MULTI_HOST,
    _existing_path,
    log_elapsed_time,
    train_args,
    train_model,
)

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
# objective + command
# --------------------------------------------------------------------------

def _objective(
    trial,
    train_params: Dict[str, Any],
    hp_params: Dict[str, Any],
    train_name: str,
    criterion: str,
    enable_trial_pruning: bool,
    device: str = "cuda",
) -> float:
    params = copy.deepcopy(train_params)
    params.update(get_hp_params(trial, hp_params))
    several = {k: params[k] for k in ("num_devices", *MULTI_HOST)
               if params.get(k) is not None and not (k == "num_devices" and params[k] == 1)}
    if several:
        raise NotImplementedError(
            f"hp-tuning runs every trial on one device; {sorted(several)} (multi-host or "
            "multi-GPU trials) wait for ROADMAP.md §1, hp-tuning over several devices")
    tags = [tuple(t) for t in params.get("tags", [])]
    tags.append(("trial", str(trial.number)))
    params["tags"] = tags
    results = train_model(
        train_name,
        train_args(params),
        device=device,
        is_hptuning=True,
        trial=trial,
        enable_trial_pruning=enable_trial_pruning,
    )
    return results.get(criterion, 0)


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


@log_elapsed_time
def hp_tuning(ns: argparse.Namespace):
    """Run the study; returns its best trial (the built-in study's record,
    or Optuna's ``FrozenTrial``)."""
    hp_params = _load_space(ns.hp_config_path)
    with open(ns.train_config_path, encoding="utf-8") as f:
        train_params = json.load(f)
    storage_path = os.path.abspath(ns.storage_path)
    os.makedirs(os.path.dirname(storage_path), exist_ok=True)
    n_trials = ns.n_trials

    train_params.setdefault("tags", [])
    train_params["tags"] = list(train_params["tags"]) + [
        ["study_name", ns.study_name]
    ]
    criterion = "test/" + train_params.get("early_criterion", "loss")
    direction = (
        "minimize" if train_params.get("early_criterion") == "loss" else "maximize"
    )

    def objective(trial):
        return _objective(
            trial,
            train_params,
            hp_params,
            ns.train_name,
            criterion,
            ns.enable_trial_pruning,
            ns.device,
        )

    if HAVE_OPTUNA:
        study = optuna.create_study(
            study_name=ns.study_name,
            storage=f"sqlite:///{storage_path}",
            load_if_exists=True,
            direction=direction,
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
        best = study.best_trial
        logger.info("best_exp_num: %s", best.number)
        logger.info("best_score: %s", best.value)
        logger.info("best_params: %s", best.params)
        return best
    logger.warning("optuna not installed — using built-in random search")
    study = RandomSearchStudy(storage_path, ns.study_name, direction)
    try:
        study.optimize(objective, n_trials=n_trials)
    except KeyboardInterrupt:
        logger.info("Stop tuning.")
    best = study.best_trial
    logger.info("best_exp_num: %s", best["number"])
    logger.info("best_score: %s", best["value"])
    logger.info("best_params: %s", best["params"])
    return best
