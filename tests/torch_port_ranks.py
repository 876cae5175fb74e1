"""What the ranks of ``tests/test_torch_port_multi_rank.py`` and
``tests/test_torch_port_hpo_multi_rank.py`` run.

The functions here run inside processes that ``core.mesh.launch`` spawns
(gloo on the CPU, one torch thread each) and, for the 1-rank references,
in the test process itself. They import torch and the port only, so a
spawned rank starts without JAX.
"""
from __future__ import annotations

import os
import signal
import time

import numpy as np
import torch

from pmgt_tpu_torch.core import mesh as tmesh
from pmgt_tpu_torch.core.config import TrainArgs
from pmgt_tpu_torch.data.synthetic import make_synthetic_dataset
from pmgt_tpu_torch.tasks import pmgt_task

# The small configuration of tests/test_sharding.py.
DATA = dict(num_nodes=40, num_users=20, feat_dims=(12, 8), avg_degree=6, seed=0)
EXTRA = dict(hidden_size=8, intermediate_size=8, num_hidden_layers=1, hop_sampling_sizes=(3, 2),
             max_ctx_neigh=3)


def small_task(extra=None, **kw) -> pmgt_task.PMGTTask:
    """The 40-node PMGT task (32 train / 8 valid nodes, batch 16) on the
    CPU, in the process's group if it has one."""
    args = TrainArgs(model_name="PMGT", dataset_name="syn", seed=0, num_epochs=1,
                     train_batch_size=16, test_batch_size=16, lr=1e-2,
                     extra={**EXTRA, **(extra or {})}, **kw)
    nodes = np.arange(2, 42, dtype=np.int32)
    return pmgt_task.PMGTTask(args, make_synthetic_dataset(**DATA), nodes[:32], nodes[32:],
                              device="cpu")


def pmgt_epoch(extra=None, kw=None) -> dict:
    """One training epoch, the training contexts, then evaluation and
    export, of the small task."""
    task = small_task(extra, **(kw or {}))
    losses = task.train_epoch(0).numpy()
    ctx = task._train_ctx
    valid = task._get_ctx(("valid",))
    return {
        "losses": losses,
        "params": {k: v.clone() for k, v in task.model.state_dict().items()},
        "train_ctx": None if ctx is None else (ctx[0].clone(), ctx[1].clone(), ctx[2]),
        "valid_ctx": valid,
        "metrics": task.evaluate("valid"),
        "emb": task.export_embeddings(),
        "num_total": task.sampling.num_total,
        "graph_rows": int(task.graph.nbr_ids.shape[0]),
        "table_rows": [int(t.local.shape[0]) if hasattr(t, "local") else int(t.shape[0])
                       for t in task.feat_tables],
        "rank": tmesh.current_mesh().rank,
    }


def pmgt_epochs(configs: dict, given=None) -> dict:
    """``pmgt_epoch`` of every (extra, kw) configuration, by name, and
    with ``given`` (``evaluate_given``'s arguments) its results."""
    out = {name: pmgt_epoch(extra, kw) for name, (extra, kw) in configs.items()}
    if given is not None:
        out["jax_params"] = evaluate_given(*given)
    return out


def evaluate_given(args_kw: dict, data: dict, state: dict, tables: dict) -> dict:
    """Evaluation and export of the given parameters over the given phase
    tables (valid and inference contexts, as the JAX task drew them), on
    the synthetic dataset of ``data``."""
    args = TrainArgs(**args_kw)
    ctx = {"artifacts": make_synthetic_dataset(**data), "device": "cpu"}
    pmgt_task.init_dataloader(args, ctx)
    pmgt_task.init_model(args, ctx)
    task = ctx["task"]
    task.model.load_state_dict(state)
    for tag, (ids, mask, pairs) in tables.items():
        task._phase_ctx_cache[tag] = (
            torch.from_numpy(ids).long(), torch.from_numpy(mask),
            None if pairs is None else (torch.from_numpy(pairs[0]).long(),
                                        torch.from_numpy(pairs[1]), torch.from_numpy(pairs[2])))
    return {"metrics": task.evaluate("valid"), "emb": task.export_embeddings()}


def _train(data_dir: str, log_dir: str, **kw):
    from pmgt_tpu_torch.cli.main import train_model

    args = TrainArgs(model_name="pmgt", dataset_name="synth", data_dir=data_dir, log_dir=log_dir,
                     seed=0, train_batch_size=16, test_batch_size=32, early=0,
                     early_criterion="auc", extra=dict(EXTRA), **kw)
    return train_model("pmgt", args, device="cpu")


def engine_flows(data_dir: str, root: str) -> dict:
    """At 2 ranks through ``train_model``: 4 uninterrupted epochs; 4 epochs
    of which rank 1 alone gets a SIGTERM as epoch 1 starts; the resume of
    that run to 4 epochs; its export (``np.save`` calls counted).
    Deterministic algorithms, so a resumed run can
    equal the uninterrupted one."""
    from pmgt_tpu_torch.train.registry import RunRegistry

    torch.use_deterministic_algorithms(True)
    rank = tmesh.current_mesh().rank
    out = {"rank": rank, "full": _train(data_dir, os.path.join(root, "full"), num_epochs=4)}
    real = pmgt_task.PMGTTask.on_epoch_start
    sent = []

    def signalled(task, epoch):
        if epoch == 1 and rank == 1 and not sent:  # once: a second signal interrupts
            sent.append(epoch)
            os.kill(os.getpid(), signal.SIGTERM)
        return real(task, epoch)

    pmgt_task.PMGTTask.on_epoch_start = signalled
    try:
        out["preempted"] = _train(data_dir, os.path.join(root, "resumed"), num_epochs=4)
    finally:
        pmgt_task.PMGTTask.on_epoch_start = real
    (run,) = RunRegistry(os.path.join(root, "resumed")).list_runs()
    out["run_id"], out["status_after_signal"] = run.run_id, run.status
    out["epochs_after_signal"] = sorted({m["epoch"] for m in run.metrics()
                                         if m["name"] == "val/auc"})
    tmesh.barrier(tmesh.current_mesh())  # every rank has read the status
    out["resumed"] = _train(data_dir, os.path.join(root, "resumed"), num_epochs=4,
                            run_id=run.run_id)
    saves, real_save = [], np.save

    def counted(*a, **k):
        saves.append(a[0])
        return real_save(*a, **k)

    np.save = counted
    try:
        out["export"] = _train(data_dir, os.path.join(root, "resumed"), mode="inference",
                               run_id=run.run_id,
                               inference_result_path=os.path.join(root, "emb.npy"))
    finally:
        np.save = real_save
    out["saves"] = len(saves)
    return out


def sleep_then_barrier(seconds: float) -> float:
    """Idle for ``seconds`` with no collective pending, then meet the
    other ranks at a barrier."""
    time.sleep(seconds)
    tmesh.barrier(tmesh.current_mesh())
    return seconds


def barrier_flow() -> str:
    """Rank 1 leaves without reaching the barrier; rank 0's barrier must
    raise."""
    mesh = tmesh.current_mesh()
    if mesh.rank == 1:
        time.sleep(2)
        return "left"
    try:
        tmesh.barrier(mesh)
    except RuntimeError as e:
        return f"raised {type(e).__name__}"
    return "passed"


class ScriptedTrial:
    """A study's trial whose ``should_prune`` is True from epoch
    ``prune_at`` on."""

    def __init__(self, number: int, prune_at: int):
        self.number, self.prune_at, self.reports = number, prune_at, []

    def report(self, value, step):
        self.reports.append((value, step))

    def should_prune(self):
        return self.reports[-1][1] >= self.prune_at


def scripted_prune(train_name: str, params: dict, prune_at: int) -> dict:
    """One trial of ``params`` through ``hpo``'s rank path with pruning
    enabled: rank 0 holds a ``ScriptedTrial``, the other ranks none."""
    from pmgt_tpu_torch.cli import hpo

    mesh = tmesh.current_mesh()
    trial = ScriptedTrial(0, prune_at) if mesh.is_primary else None
    records = []
    msg = {"number": 0, "params": params, "suggested": {}}
    hpo._train_trial(msg, train_name, "test/" + params["early_criterion"], True, "cpu", mesh,
                     trial, records)
    return {"rank": mesh.rank, "record": records[0],
            "reports": None if trial is None else trial.reports}
