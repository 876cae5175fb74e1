"""Filesystem run registry (counterpart of ``pmgt_tpu/train/registry.py``,
single-process). The run directory has the JAX package's layout, so
either package can list the other's runs:

    <log_dir>/<experiment_name>/<run_id>/
        params.json      resolved TrainArgs (hyperparameter restore source)
        tags.json        user tags + host info
        status           RUNNING | FINISHED | FAILED | INTERRUPTED
        metrics.jsonl    one {"step", "epoch", "name", "value"} per line
        checkpoints/
            best/        best checkpoint by the early-stopping monitor
            best.json    {"monitor", "value", "epoch"}
            last/        latest checkpoint
        artifacts/       run scripts etc.

The checkpoint directories themselves are the port's format
(``train/checkpoints.py``), not orbax's.

In a data-parallel group only rank 0 writes; ``create_run`` broadcasts its
run id to the other ranks (a failed broadcast raises), so every rank
names the one run.
"""
from __future__ import annotations

import json
import logging
import os
import platform
import shutil
import time
import uuid
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from pmgt_tpu_torch.core.mesh import broadcast_object, current_mesh
from pmgt_tpu_torch.train.checkpoints import checkpoint_exists

logger = logging.getLogger("pmgt_tpu_torch")


@dataclass
class RunInfo:
    run_id: str
    experiment_name: str
    run_dir: str

    @property
    def params(self) -> Dict[str, Any]:
        with open(os.path.join(self.run_dir, "params.json"), encoding="utf-8") as f:
            return json.load(f)

    @property
    def status(self) -> str:
        path = os.path.join(self.run_dir, "status")
        if not os.path.exists(path):
            return "UNKNOWN"
        with open(path, encoding="utf-8") as f:
            return f.read().strip()

    @property
    def ckpt_dir(self) -> str:
        return os.path.join(self.run_dir, "checkpoints")

    def metrics(self) -> List[Dict[str, Any]]:
        path = os.path.join(self.run_dir, "metrics.jsonl")
        if not os.path.exists(path):
            return []
        with open(path, encoding="utf-8") as f:
            return [json.loads(line) for line in f if line.strip()]


class RunRegistry:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir

    def create_run(
        self,
        experiment_name: str,
        params: Dict[str, Any],
        run_name: Optional[str] = None,
        tags: Optional[Dict[str, Any]] = None,
        run_script: Optional[str] = None,
        run_id: Optional[str] = None,
    ) -> RunInfo:
        """Create the run directory (rank 0) and return the run on every
        rank: rank 0's id reaches the others once its files are written."""
        mesh = current_mesh()
        if mesh.is_primary:
            run_id = run_id or uuid.uuid4().hex
            self._write_run(experiment_name, run_id, params, run_name, tags, run_script)
        run_id = broadcast_object(mesh, run_id if mesh.is_primary else None)
        return RunInfo(run_id, experiment_name, os.path.join(self.log_dir, experiment_name, run_id))

    def _write_run(self, experiment_name, run_id, params, run_name, tags, run_script) -> None:
        run_dir = os.path.join(self.log_dir, experiment_name, run_id)
        os.makedirs(os.path.join(run_dir, "checkpoints"), exist_ok=True)
        os.makedirs(os.path.join(run_dir, "artifacts"), exist_ok=True)
        all_tags = {
            "run_name": run_name,
            "host": platform.node(),
            "created_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
        }
        all_tags.update(tags or {})
        with open(os.path.join(run_dir, "params.json"), "w", encoding="utf-8") as f:
            json.dump(params, f, indent=2, default=str)
        with open(os.path.join(run_dir, "tags.json"), "w", encoding="utf-8") as f:
            json.dump(all_tags, f, indent=2, default=str)
        if run_script and os.path.exists(run_script):
            shutil.copy(
                run_script,
                os.path.join(run_dir, "artifacts", os.path.basename(run_script)),
            )
        self.set_status(RunInfo(run_id, experiment_name, run_dir), "RUNNING")

    def get_run(self, run_id: str) -> RunInfo:
        """Find a run by id across experiments."""
        if os.path.isdir(self.log_dir):
            for exp in sorted(os.listdir(self.log_dir)):
                run_dir = os.path.join(self.log_dir, exp, run_id)
                if os.path.isdir(run_dir):
                    return RunInfo(run_id, exp, run_dir)
        raise FileNotFoundError(f"run {run_id} not found under {self.log_dir}")

    def list_runs(self, experiment_name: Optional[str] = None) -> List[RunInfo]:
        """All runs (optionally of one experiment), newest first by their
        ``created_at`` tag. A run directory is one with ``params.json``."""
        runs: List[RunInfo] = []
        if not os.path.isdir(self.log_dir):
            return runs
        exps = (
            [experiment_name]
            if experiment_name is not None
            else sorted(os.listdir(self.log_dir))
        )
        for exp in exps:
            exp_dir = os.path.join(self.log_dir, exp)
            if not os.path.isdir(exp_dir):
                continue
            for rid in sorted(os.listdir(exp_dir)):
                run_dir = os.path.join(exp_dir, rid)
                if os.path.isfile(os.path.join(run_dir, "params.json")):
                    runs.append(RunInfo(rid, exp, run_dir))

        def created(r: RunInfo) -> str:
            try:
                with open(os.path.join(r.run_dir, "tags.json"), encoding="utf-8") as f:
                    return json.load(f).get("created_at") or ""
            except (OSError, ValueError):
                return ""

        return sorted(runs, key=created, reverse=True)

    def set_status(self, run: RunInfo, status: str) -> None:
        if not current_mesh().is_primary:
            return
        with open(os.path.join(run.run_dir, "status"), "w", encoding="utf-8") as f:
            f.write(status + "\n")

    def log_metrics(
        self, run: RunInfo, metrics: Dict[str, float], step: int, epoch: int
    ) -> None:
        if not current_mesh().is_primary:
            return
        with open(os.path.join(run.run_dir, "metrics.jsonl"), "a", encoding="utf-8") as f:
            for name, value in metrics.items():
                row = {"step": int(step), "epoch": int(epoch), "name": name,
                       "value": float(value)}
                f.write(json.dumps(row) + "\n")

    def get_ckpt_path(self, run_id: str, load_best: bool = False) -> str:
        """The run's ``best`` or ``last`` checkpoint directory; ``best``
        falls back to ``last``. Raises when neither exists."""
        run = self.get_run(run_id)
        path = os.path.join(run.ckpt_dir, "best" if load_best else "last")
        if not checkpoint_exists(path):
            if load_best:
                path = os.path.join(run.ckpt_dir, "last")
            if not checkpoint_exists(path):
                raise FileNotFoundError(f"no checkpoint under {run.ckpt_dir}")
        return path


def locate_eval_ckpt(
    registry: Optional[RunRegistry],
    run: Optional[RunInfo],
    explicit_run_id: Optional[str],
    load_best: bool = True,
) -> Optional[str]:
    """The checkpoint to evaluate or export from. A missing checkpoint of
    an explicitly requested ``--run-id`` is an error (never score freshly
    initialised parameters as a run's results); for the run just trained
    it is a warning and the in-memory parameters are used. None when
    there is nothing to restore."""
    run_id = explicit_run_id or (run.run_id if run is not None else None)
    if run_id is None:
        return None
    if registry is None:
        if explicit_run_id is not None:
            raise FileNotFoundError(
                f"--run-id {explicit_run_id!r} was given but no registry/"
                f"log-dir is available to resolve it"
            )
        return None
    try:
        return registry.get_ckpt_path(run_id, load_best=load_best)
    except FileNotFoundError:
        if explicit_run_id is not None:
            raise FileNotFoundError(
                f"--run-id {explicit_run_id!r} was given but no checkpoint "
                f"exists for it; refusing to evaluate in-memory params"
            ) from None
        logger.warning(
            "no checkpoint found for run %s; evaluating in-memory params", run_id
        )
        return None
