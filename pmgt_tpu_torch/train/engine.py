"""Training engine: the epoch loop with early stopping, best/last
checkpoints, metric logging, resume, preemption and SWA (counterpart of
``pmgt_tpu/train/engine.py`` ``fit``, in the per-epoch form).

The task is mutable, in PyTorch's idiom (``Task`` below): it trains one
epoch at a time and returns that epoch's per-step losses as one device
tensor, which the engine fetches once per evaluation group, never once per
step. The JAX engine's scan, speculative and pipelined dispatch have no
counterpart. Everything the engine decides (patience, checkpoints, rows of
``metrics.jsonl``, status) follows the JAX ``fit``.

In a data-parallel group every rank runs ``fit`` on the same metrics (the
task all-reduces its losses and gathers its evaluation outputs), so every
rank takes the same decisions; only rank 0 writes (``train/registry.py``,
``train/checkpoints.py``). A resume loads rank 0's ``last`` on every rank,
the preemption flag is max-reduced at each evaluation point (a signal to
one rank stops every rank after the same epoch; without it the others
would wait in the next collective), and ``fit`` ends with a barrier, so no
rank reads a checkpoint before rank 0 has written it.

Under a profiler session (``--profile-dir``) each epoch's refresh and
steps and each evaluation is a span of ``core/tracing.py``: ``epoch``,
``evaluate`` (each checkpoint save is ``train/checkpoints.py``'s
``checkpoint``).
"""
from __future__ import annotations

import logging
import os
import time
from contextlib import contextmanager
from typing import Any, Dict, Optional, Protocol

import numpy as np
import torch

from pmgt_tpu_torch.core.mesh import any_rank, barrier, broadcast_object, current_mesh
from pmgt_tpu_torch.core.tracing import span
from pmgt_tpu_torch.train.checkpoints import (
    checkpoint_exists,
    restore_checkpoint,
    save_checkpoint,
    write_best_info,
)
from pmgt_tpu_torch.train.registry import RunInfo, RunRegistry

logger = logging.getLogger("pmgt_tpu_torch")


class Task(Protocol):
    """Workload plug-in for the engine. Optional: ``on_epoch_start(epoch)``,
    ``on_resume(global_step, start_epoch)``, ``should_prune(value,
    epoch)`` and ``model`` (an ``nn.Module``, needed for SWA)."""

    def train_epoch(self, epoch: int) -> Any:
        """Train one epoch; returns its per-step losses [steps]."""

    def evaluate(self, split: str) -> Dict[str, float]:
        ...

    def state_dict(self) -> Dict[str, Any]:
        ...

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        ...


class SWAAverager:
    """Stochastic Weight Averaging over end-of-epoch parameters:
    avg_{n+1} = (avg_n * n + p) / (n + 1)."""

    def __init__(self):
        self.n = 0
        self.avg: Optional[Dict[str, torch.Tensor]] = None

    @torch.no_grad()
    def update(self, model: torch.nn.Module) -> None:
        params = {k: p.detach() for k, p in model.named_parameters()}
        if self.avg is None:
            self.avg = {k: p.clone() for k, p in params.items()}
            self.n = 1
            return
        n = self.n
        self.avg = {k: (a * n + params[k]) / (n + 1) for k, a in self.avg.items()}
        self.n += 1


@contextmanager
def _parameters_swapped(model: torch.nn.Module, params: Dict[str, torch.Tensor]):
    """Run the body with ``params`` copied into ``model``, then put the
    model's own parameters back."""
    own = {k: p.detach().clone() for k, p in model.named_parameters()}
    named = dict(model.named_parameters())
    with torch.no_grad():
        for k, v in params.items():
            named[k].copy_(v)
    try:
        yield
    finally:
        with torch.no_grad():
            for k, v in own.items():
                named[k].copy_(v)


def _is_better(value: float, best: Optional[float], mode: str) -> bool:
    if best is None or not np.isfinite(best):
        return True
    return value < best if mode == "min" else value > best


def _ckpt_payload(state, *, epoch, global_step, patience, best_value, has_best=True):
    """The one checkpoint payload schema (state + resume meta), shared by
    every save site."""
    return {
        "state": state,
        "meta": {
            "epoch": epoch,
            "global_step": global_step,
            "patience": patience,
            "best_value": float(best_value) if best_value is not None else 0.0,
            "has_best": has_best,
        },
    }


def criterion_mode(criterion: str) -> str:
    """Loss-like criteria are minimized, everything else maximized."""
    return "min" if "loss" in criterion else "max"


def _fetch(losses: Any) -> np.ndarray:
    """One epoch's per-step losses as float64 on the host (one copy)."""
    if isinstance(losses, torch.Tensor):
        return losses.detach().to("cpu", torch.float64).numpy()
    return np.asarray(losses, dtype=np.float64)


class _PreemptionGuard:
    """SIGTERM/SIGINT-safe training: the first signal requests a graceful
    stop (the evaluation group finishes, ``last`` is written, the status
    becomes INTERRUPTED); a second signal raises KeyboardInterrupt. The
    previous handlers come back on exit."""

    def __init__(self):
        self.requested = False
        self._previous = {}

    def __enter__(self):
        import signal

        def handler(signum, frame):
            if self.requested:
                raise KeyboardInterrupt
            self.requested = True
            logger.warning(
                "received signal %s: finishing the current epoch, "
                "checkpointing, then stopping",
                signum,
            )

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._previous[sig] = signal.signal(sig, handler)
            except (ValueError, OSError):  # not the main thread
                pass
        return self

    def __exit__(self, *exc):
        import signal

        for sig, prev in self._previous.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        return False


def task_should_prune(task: Task, value: float, epoch: int) -> bool:
    """Optuna-style pruning hook."""
    hook = getattr(task, "should_prune", None)
    if hook is None:
        return False
    return bool(hook(value, epoch))


def fit(
    task: Task,
    *,
    num_epochs: int,
    early: int,
    early_criterion: str,
    registry: Optional[RunRegistry] = None,
    run: Optional[RunInfo] = None,
    resume: bool = False,
    swa_start: Optional[int] = None,
    eval_interval: int = 1,
    ckpt_interval: int = 1,
    eval_init: bool = False,
) -> Dict[str, float]:
    """Run the train/validate loop. Returns the last validation metrics
    plus ``best`` (the best monitored value seen); with ``swa_start`` set,
    also ``swa/<metric>`` of the weight-averaged model.

    - ``eval_interval=k`` evaluates, checkpoints and early-stops every k
      epochs (patience counts evaluation points; a preemption signal is
      honoured at group ends). Every epoch still logs its ``loss/train``.
    - ``ckpt_interval=k`` saves ``last`` at every k-th evaluation point of
      this run, and always when the run stops (last epoch, early stop,
      pruning, preemption). ``best`` (and ``best.json``) is saved whenever
      the monitor improves.
    - ``eval_init`` evaluates the initial parameters first and seeds the
      best tracking with them (epoch -1): if no epoch beats them, ``best``
      is the initialisation.
    - ``resume`` restores ``last`` (model, optimizer, epoch, step,
      patience, best value) and calls ``task.on_resume(global_step,
      start_epoch)``.
    """
    if eval_interval < 1:
        raise ValueError(f"eval_interval must be >= 1, got {eval_interval}")
    if ckpt_interval < 1:
        raise ValueError(f"ckpt_interval must be >= 1, got {ckpt_interval}")
    monitor = f"val/{early_criterion}"
    mode = criterion_mode(early_criterion)
    swa = SWAAverager() if swa_start is not None else None
    if swa is not None and eval_interval > 1:
        logger.warning(
            "swa_start with eval_interval=%d averages only group-end "
            "params (every %d epochs), not every epoch",
            eval_interval,
            eval_interval,
        )
    mesh = current_mesh()
    logged_run = registry is not None and run is not None
    if logged_run:
        # Clears a stale INTERRUPTED/FAILED status when resuming.
        registry.set_status(run, "RUNNING")

    start_epoch = 0
    best_value: Optional[float] = None
    patience = 0
    global_step = 0
    ckpt_dir = run.ckpt_dir if run is not None else None

    if resume and ckpt_dir is not None:
        last = os.path.join(ckpt_dir, "last")
        # rank 0 looks first (and promotes a stranded copy), then every
        # rank restores the same checkpoint
        if broadcast_object(mesh, checkpoint_exists(last) if mesh.is_primary else None):
            payload = restore_checkpoint(last)
            task.load_state_dict(payload["state"])
            meta = payload["meta"]
            start_epoch = int(meta["epoch"]) + 1
            global_step = int(meta["global_step"])
            patience = int(meta["patience"])
            best_value = float(meta["best_value"]) if meta["has_best"] else None
            logger.info(
                "resumed from %s at epoch %d (step %d)", last, start_epoch, global_step
            )
            on_resume = getattr(task, "on_resume", None)
            if on_resume is not None:
                on_resume(global_step, start_epoch)

    val_metrics: Dict[str, float] = {}

    if eval_init and start_epoch == 0:
        with span("evaluate"):
            init_metrics = task.evaluate("valid")
        if monitor not in init_metrics:
            raise KeyError(
                f"early criterion {monitor!r} not in metrics {sorted(init_metrics)}"
            )
        best_value = init_metrics[monitor]
        val_metrics = dict(init_metrics)
        logger.info(
            "init eval (before any training): %s",
            " ".join(f"{k} {v:.5f}" for k, v in init_metrics.items()),
        )
        if logged_run:
            registry.log_metrics(run, init_metrics, step=0, epoch=-1)
        if ckpt_dir is not None:
            payload = _ckpt_payload(
                task.state_dict(), epoch=-1, global_step=0, patience=0,
                best_value=best_value,
            )
            save_checkpoint(os.path.join(ckpt_dir, "best"), payload)
            write_best_info(ckpt_dir, monitor, best_value, -1)

    on_epoch_start = getattr(task, "on_epoch_start", None)
    eval_count = 0  # evaluation points of this run (ckpt_interval keys on them)
    with _PreemptionGuard() as guard:
        e0 = start_epoch
        while e0 < num_epochs:
            g = min(eval_interval, num_epochs - e0)
            epoch = e0 + g - 1  # the group's evaluation epoch
            epoch_start = time.time()
            outs = []
            for e in range(e0, e0 + g):
                with span("epoch"):
                    if on_epoch_start is not None:
                        on_epoch_start(e)
                    outs.append(task.train_epoch(e))
            epoch_losses = [_fetch(x) for x in outs]  # the group's one fetch
            batch_counts = [len(r) for r in epoch_losses]

            # loss/train rows of the group's unevaluated epochs
            step_base = global_step
            for j, e in enumerate(range(e0, epoch)):
                row = epoch_losses[j]
                step_base += batch_counts[j]
                if logged_run:
                    registry.log_metrics(
                        run,
                        {"loss/train": float(row.mean()) if len(row) else float("nan")},
                        step=step_base,
                        epoch=e,
                    )
            global_step += sum(batch_counts)
            last_row = epoch_losses[-1]
            train_loss = float(last_row.mean()) if len(last_row) else float("nan")
            tail_loss = float(last_row[-100:].mean()) if len(last_row) else float("nan")

            with span("evaluate"):
                val_metrics = task.evaluate("valid")
            eval_count += 1
            elapsed = time.time() - epoch_start
            logged = {
                "loss/train": train_loss,
                "loss/train_last100": tail_loss,
                **val_metrics,
                "epoch_time": elapsed,
            }
            if logged_run:
                registry.log_metrics(run, logged, step=global_step, epoch=epoch)
            logger.info(
                "epoch %d done in %.1fs: train_loss %.5f %s",
                epoch,
                elapsed,
                train_loss,
                " ".join(f"{k} {v:.5f}" for k, v in val_metrics.items()),
            )

            if swa is not None and epoch >= swa_start and hasattr(task, "model"):
                swa.update(task.model)

            if monitor not in val_metrics:
                raise KeyError(
                    f"early criterion {monitor!r} not in metrics {sorted(val_metrics)}"
                )
            value = val_metrics[monitor]
            improved = _is_better(value, best_value, mode)
            if improved:
                best_value = value
                patience = 0
            else:
                patience += 1

            # Stop decisions come before checkpointing, so a stopping run
            # always saves a resumable `last`.
            prune = task_should_prune(task, value, epoch)
            stop_early = bool(early and patience >= early)
            preempted = any_rank(mesh, guard.requested)
            stopping = preempted or prune or stop_early or (e0 + g) >= num_epochs
            if ckpt_dir is not None:
                do_last = stopping or eval_count % ckpt_interval == 0
                # One payload, serialized once, for `last` and `best` both.
                targets = [os.path.join(ckpt_dir, name) for name, wanted in
                           (("last", do_last), ("best", improved)) if wanted]
                if targets:
                    save_checkpoint(targets, _ckpt_payload(
                        task.state_dict(), epoch=epoch, global_step=global_step,
                        patience=patience, best_value=best_value,
                    ))
                if improved:
                    write_best_info(ckpt_dir, monitor, best_value, epoch)

            if preempted:
                if logged_run:
                    registry.set_status(run, "INTERRUPTED")
                logger.warning(
                    "stopping after epoch %d (preemption signal); resume with "
                    "--run-id",
                    epoch,
                )
                break
            if prune:
                logger.info("trial pruned at epoch %d", epoch)
                break
            if stop_early:
                logger.info("early stopping at epoch %d (patience %d)", epoch, early)
                break
            e0 += g

    results = dict(val_metrics)
    results["best"] = float(best_value) if best_value is not None else float("nan")

    if swa is not None and swa.avg is not None:
        with _parameters_swapped(task.model, swa.avg), span("evaluate"):
            swa_metrics = task.evaluate("valid")
        results.update({f"swa/{k}": v for k, v in swa_metrics.items()})
        if ckpt_dir is not None:
            save_checkpoint(
                os.path.join(ckpt_dir, "swa"), {"params": swa.avg, "n_models": swa.n}
            )
        logger.info(
            "SWA (%d models): %s",
            swa.n,
            " ".join(f"{k} {v:.5f}" for k, v in swa_metrics.items()),
        )
        if logged_run:
            registry.log_metrics(
                run,
                {f"swa/{k}": v for k, v in swa_metrics.items()},
                step=global_step,
                epoch=num_epochs,
            )
    barrier(mesh)
    return results
