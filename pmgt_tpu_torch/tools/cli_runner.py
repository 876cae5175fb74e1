"""What the evidence tools share: the port's CLI and the tools' own seed
workers in subprocesses, the ``hp-tuning`` extension loop, the restore of
a study's best trial, and the K1–K4 launches of a PMGT process.

A CLI subprocess's launches come from its last log line (the console
entry logs them); a study's per-trial records from its trials JSON, where
``hp-tuning`` stores each trained trial's value, results, seconds and
launches with the trial (the user attribute ``record``).
"""
from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from pmgt_tpu_torch.ops.dual_attention import launch_counts
from pmgt_tpu_torch.tools import validate_pipeline as vp
from pmgt_tpu_torch.train.registry import RunRegistry

REPO = vp.REPO
ROUNDS = 4  # hp-tuning invocations at most (tools/hpo_tg_study.py:226)
RESTORE_TOL = 1e-5  # the restored best checkpoint against its trial's logged results
NO_LAUNCHES = {"k1": 0, "k2": 0, "k3": 0, "k4": 0}
SEED_THREADS = 2  # CPU threads of each process fanned out on the card
POLL_S = 0.05  # how often run_processes looks for processes that exited


# ----------------------------------------------------------------------
# subprocesses
# ----------------------------------------------------------------------

def run_cli(args: Sequence[Any], device: str) -> str:
    """One command of the port's CLI in a subprocess on ``device``; its
    output (stdout then stderr). A command that fails raises with the
    tail of its output."""
    cmd = [sys.executable, "-m", "pmgt_tpu_torch.cli.main", "--device", device,
           *[str(a) for a in args]]
    print("+", " ".join(cmd), flush=True)
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True)
    out = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"CLI failed: {args[0]} (exit {res.returncode}):\n{out[-4000:]}")
    return out


def run_processes(jobs: Dict[Any, Tuple[List[str], str]]) -> Dict[Any, float]:
    """Every job ``{key: (argv, log path)}`` at once, each a process of its
    own from the repo's root with ``SEED_THREADS`` CPU threads and its
    output in its log (host bound, the card mostly idle); waits for all
    and returns each one's wall seconds, taken when that process exits
    (polled every ``POLL_S``), in the jobs' order. A process that fails
    raises with its log's tail as soon as it is seen to exit; every
    process is stopped before this returns."""
    env = dict(os.environ, OMP_NUM_THREADS=str(SEED_THREADS), MKL_NUM_THREADS=str(SEED_THREADS))
    procs, seconds = {}, {}
    try:
        for key, (argv, log_path) in jobs.items():
            with open(log_path, "w") as log:
                procs[key] = (log_path, time.perf_counter(),
                              subprocess.Popen(argv, cwd=REPO, env=env, stdout=log,
                                               stderr=subprocess.STDOUT))
        while len(seconds) < len(procs):
            for key, (log_path, t0, p) in procs.items():
                if key in seconds or p.poll() is None:
                    continue
                seconds[key] = time.perf_counter() - t0
                if p.returncode != 0:
                    with open(log_path) as f:
                        raise RuntimeError(f"{key} failed (rc {p.returncode}):\n"
                                           f"{f.read()[-3000:]}")
            if len(seconds) < len(procs):
                time.sleep(POLL_S)
    finally:
        for *_, p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return {key: seconds[key] for key in jobs}


def last_run_id(out: str) -> str:
    ids = re.findall(r"run_id: ([0-9a-f]{32})", out)
    if not ids:
        raise RuntimeError("no run_id in CLI output")
    return ids[-1]


def launches_of(out: str) -> Dict[str, int]:
    """The K1–K4 launches a CLI process logged last."""
    found = re.findall(r"kernel launches: (\{.*\})", out)
    if not found:
        raise RuntimeError("no kernel launches in CLI output")
    return json.loads(found[-1])


def test_results(out: str) -> Optional[Dict[str, float]]:
    found = re.findall(r"test results: (\{.*\})", out)
    return ast.literal_eval(found[-1]) if found else None


# ----------------------------------------------------------------------
# studies
# ----------------------------------------------------------------------

def make_tg_dataset(tg_dir: str, signal: float, device: str) -> Dict[str, Any]:
    """``make-synthetic --shape TG`` at ``signal`` into ``tg_dir`` unless a
    dataset is there; its stage record."""
    if not os.path.exists(os.path.join(tg_dir, "meta.json")):
        run_cli(["make-synthetic", "--out-dir", tg_dir, "--shape", "TG", "--seed", 42,
                 "--signal", signal], device)
    return {"stage": "dataset", "path": tg_dir}


def num_nodes_of(tg_dir: str) -> int:
    with open(os.path.join(tg_dir, "meta.json"), encoding="utf-8") as f:
        return int(json.load(f)["num_nodes"])


def evaluations(run) -> int:
    """Validation points a run logged (one an epoch)."""
    return sum(m["name"] in ("val/auc", "val/n20") for m in run.metrics())


def tagged_run(log_dir: str, experiment: str, number: int):
    """The registry run of trial ``number`` (tools/hpo_tg_study.py:253-263)."""
    for run in RunRegistry(log_dir).list_runs(experiment):
        with open(os.path.join(run.run_dir, "tags.json"), encoding="utf-8") as f:
            if json.load(f).get("trial") == str(number):
                return run
    raise RuntimeError(f"no registry run tagged trial={number}")


def study(args: List[Any], n_trials: int, trials_path: str,
          done: Callable[[int, int], bool], device: str,
          rounds: int = ROUNDS) -> Dict[str, Any]:
    """``hp-tuning`` with ``args`` at ``--n-trials n_trials``, then again
    one trial more at a time until ``done(n_complete, n_pruned)`` or
    ``rounds`` invocations (tools/hpo_tg_study.py:226-238): the stored
    trials (without their records), their counts, each trained trial's
    record from the trials JSON and the seconds of each invocation."""
    seconds = []
    target = n_trials
    for _ in range(rounds):
        t = time.perf_counter()
        run_cli(["hp-tuning", *args, "--n-trials", target], device)
        seconds.append(time.perf_counter() - t)
        with open(trials_path, encoding="utf-8") as f:
            trials = json.load(f)
        counts = (sum(t["state"] == "COMPLETE" for t in trials),
                  sum(t["state"] == "PRUNED" for t in trials))
        if done(*counts):
            break
        target += 1
    records = {t["number"]: t.pop("user_attrs")["record"] for t in trials if "user_attrs" in t}
    return {"trials": trials, "n_complete": counts[0], "n_pruned": counts[1],
            "records": records, "invocation_s": seconds}


def restore_in_process(train_name: str, run, device: str) -> Dict[str, Any]:
    """The run's best checkpoint evaluated in this process as its trial
    evaluated it (``is_hptuning``: the validation split, labelled
    ``test/``), with the run's own arguments: its results and launches."""
    from pmgt_tpu_torch.cli.main import train_args, train_model

    args = train_args({**run.params, "mode": "eval", "run_id": run.run_id, "num_devices": 1})
    before = launch_counts()
    results = train_model(train_name, args, device=device, is_hptuning=True)
    after = launch_counts()
    return {"results": results, "launches": {k: after[k] - before[k] for k in after}}


def restore_check(logged: Dict[str, float], restored: Dict[str, float]) -> Dict[str, Any]:
    diff = max(abs(restored[k] - v) for k, v in logged.items())
    return {"check": "restored best == its logged results (1e-5)", "max_abs_diff": diff,
            "bound": RESTORE_TOL, "ok": bool(set(restored) == set(logged) and diff <= RESTORE_TOL)}


# ----------------------------------------------------------------------
# K1–K4 of a PMGT process
# ----------------------------------------------------------------------

def pmgt_run_launches(num_nodes: int, valid_size: float, train_batch: int, test_batch: int,
                      layers: int, epochs: int, tests: int = 1, export_batch: int = 0,
                      seed: int = 0) -> Dict[str, int]:
    """K1–K4 of one PMGT process on the card, from the code: K2 = L a
    training step; K1 = L a step, L a validation chunk at each of
    ``epochs`` evaluations and ``tests`` test evaluations (both over the
    validation nodes), and L an export chunk of ``export_batch`` nodes."""
    from pmgt_tpu_torch.graph.container import NUM_SPECIAL_NODES
    from pmgt_tpu_torch.tasks.pmgt_task import train_valid_split

    nodes = np.arange(NUM_SPECIAL_NODES, num_nodes + NUM_SPECIAL_NODES)
    train_nodes, valid_nodes = train_valid_split(nodes, valid_size, seed)
    steps = epochs * (len(train_nodes) // train_batch)
    chunks = -(-len(valid_nodes) // test_batch)
    export = -(-num_nodes // export_batch) if export_batch else 0
    return {"k1": layers * (steps + chunks * (epochs + tests) + export),
            "k2": layers * steps, "k3": 0, "k4": 0}


def expected(device: str, launches: Dict[str, int]) -> Dict[str, int]:
    """The kernels launch only on the card; the plain route counts none."""
    return launches if device != "cpu" else dict(NO_LAUNCHES)
