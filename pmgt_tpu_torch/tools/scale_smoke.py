"""Production-scale smoke of the port: sustained PMGT pre-training at
node counts far above TG's (counterpart of ``tools/scale_smoke.py``).

    python -m pmgt_tpu_torch.tools.scale_smoke [--num-nodes 100000] [--epochs 3]

A synthetic TG-layout dataset (``data/synthetic.make_synthetic_dataset``:
feature widths 1536/768, 100 users) goes through ``PMGTTask`` at the
default width (hidden 128, 5 layers, 1 head, hops 16/8/4) under the bf16
policy (lr 1e-4, max-norm 5.0) with every node a training node and the
first ``--batch`` nodes the validation nodes: a warm-up epoch 0, then
``--epochs`` measured epochs of ``train_epoch`` (each its per-epoch
context and pair refresh, then every full batch), then the validation
pair-AUC. ``--steps N`` stops each epoch after N steps (a capacity run).

Every line printed is one JSON object: the generation and task-build
seconds; the feature and graph tables' bytes, in total and on this rank;
the refresh budget (``PMGTTask.refresh``: the card's memory, what the
tables and resident draws hold, the effective chunk) with the measured
peak of one chunk's transient beside its formula; per epoch the steps,
the last loss, the refresh ms, ms a step and nodes/s; then the median
rate and the validation AUC. Times are the host clock with
``torch.cuda.synchronize()`` before each stop; memory comes from
``torch.cuda.max_memory_allocated`` (None on the CPU).

``--num-devices N`` runs N data-parallel ranks (``core/mesh.launch``:
NCCL over N cards, gloo on the CPU), each generating the same dataset
from the seed; ``--shard-feat-tables`` and ``--shard-graph-tables``
row-shard the tables over them, and each rank's table bytes must then be
the total over N up to the padding of the block.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from pmgt_tpu_torch.core import mesh as tmesh
from pmgt_tpu_torch.core.config import TrainArgs
from pmgt_tpu_torch.data.synthetic import make_synthetic_dataset
from pmgt_tpu_torch.graph.container import NUM_SPECIAL_NODES
from pmgt_tpu_torch.sampling.mcn import sample_context
from pmgt_tpu_torch.sampling.pairs import refresh_transient_bytes
from pmgt_tpu_torch.core.quant import table_nbytes
from pmgt_tpu_torch.tasks.pmgt_task import PMGTTask

FEAT_DIMS = (1536, 768)
MODEL = dict(hidden_size=128, intermediate_size=128, num_hidden_layers=5, num_attention_heads=1)


def make_dataset(num_nodes: int, avg_degree: int = 16, seed: int = 0):
    """The smoke's synthetic dataset (the JAX tool's arguments)."""
    return make_synthetic_dataset(num_nodes=num_nodes, num_users=100, feat_dims=FEAT_DIMS,
                                  interactions_per_user=2, avg_degree=avg_degree, seed=seed)


def train_args(batch: int = 512, *, feat_tables_dtype: Optional[str] = None,
               shard_feat_tables: bool = False, shard_graph_tables: bool = False,
               num_devices: Optional[int] = None, mp_enabled: bool = True,
               **extra) -> TrainArgs:
    """The smoke's ``TrainArgs`` (the JAX tool's): the default width, lr
    1e-4, max-norm 5.0, the bf16 policy unless ``mp_enabled`` is False;
    ``extra`` adds task options (e.g. ``attention_impl``)."""
    ex = dict(MODEL, **extra)
    if shard_feat_tables:
        ex["shard_feat_tables"] = True
    if shard_graph_tables:
        ex["shard_graph_tables"] = True
    if feat_tables_dtype:
        ex["feat_tables_dtype"] = feat_tables_dtype
    return TrainArgs(model_name="PMGT", dataset_name="scale-smoke", seed=0, num_epochs=1,
                     train_batch_size=batch, test_batch_size=batch, lr=1e-4,
                     mp_enabled=mp_enabled, gradient_max_norm=5.0, num_devices=num_devices,
                     extra=ex)


def build_task(art, args: TrainArgs, device="cuda") -> PMGTTask:
    """Every node a training node; the first batch of nodes validates."""
    nodes = np.arange(NUM_SPECIAL_NODES, art.num_nodes + NUM_SPECIAL_NODES, dtype=np.int64)
    return PMGTTask(args, art, nodes, nodes[: args.train_batch_size], device=device)


def table_bytes(task: PMGTTask) -> Dict[str, int]:
    """The feature tables' bytes in total (every row, on no rank in
    particular) and on this rank, and this rank's graph tables."""
    total = 0
    for t, a in zip(task.feat_tables, task.artifacts.feat_init_embs):
        local = t.local if hasattr(t, "local") else t
        q = getattr(local, "q", local)
        per_row = q.element_size() * int(np.prod(q.shape[1:]))
        if hasattr(local, "scale"):
            per_row += local.scale.element_size()
        total += per_row * int(a.shape[0])
    return {"feat_total": total, "feat_rank": sum(table_nbytes(t) for t in task.feat_tables),
            "graph_rank": task.graph.nbytes}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_build(art, args: TrainArgs, device="cuda"):
    """(``build_task``, its seconds to a synchronised stop)."""
    t0 = time.perf_counter()
    task = build_task(art, args, device)
    _sync(task.device)
    return task, time.perf_counter() - t0


def memory(device, reset: bool = False) -> Dict[str, Optional[int]]:
    """The card's allocated bytes now and at most since the last reset
    (then reset them, with ``reset``); None off the card."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"allocated_bytes": None, "peak_allocated_bytes": None}
    out = {"allocated_bytes": torch.cuda.memory_allocated(device),
           "peak_allocated_bytes": torch.cuda.max_memory_allocated(device)}
    if reset:
        torch.cuda.reset_peak_memory_stats(device)
    return out


def peak_over(device: torch.device, fn):
    """(fn(), the most bytes allocated during it over those allocated
    before it): None off the card."""
    if device.type != "cuda":
        return fn(), None
    _sync(device)
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    out = fn()
    _sync(device)
    return out, torch.cuda.max_memory_allocated(device) - base


def chunk_transient(task: PMGTTask, chunk: int, seed: int = 0) -> Dict[str, Any]:
    """One refresh chunk of ``chunk`` nodes (``sample_context``, as the
    refresh draws it): the measured peak over the bytes allocated before
    it, against ``refresh_transient_bytes``. The chunk's node ids wrap
    around the graph's rows when it has fewer."""
    nodes = torch.arange(chunk, device=task.device) % task.sampling.num_total
    gen = torch.Generator(device=task.device).manual_seed(seed)
    _, peak = peak_over(task.device, lambda: sample_context(task.graph, nodes, task.sampling, gen))
    formula = refresh_transient_bytes(task.sampling, chunk)
    return {"chunk": chunk, "measured_bytes": peak, "formula_bytes": formula,
            "measured_over_formula": None if peak is None else peak / formula}


def run_epoch(task: PMGTTask, epoch: int, steps: Optional[int] = None) -> Dict[str, Any]:
    """The epoch's refresh, then its steps (all, or the first ``steps``),
    each timed to a synchronised stop."""
    dev = task.device
    _sync(dev)
    t0 = time.perf_counter()
    _, refresh_peak = peak_over(dev, lambda: task.on_epoch_start(epoch))
    _sync(dev)
    t1 = time.perf_counter()
    if steps is None:
        losses = task.train_epoch(epoch)
    else:
        batches = task.train_batches(epoch)
        losses = torch.stack([task.train_step(next(batches))["loss"] for _ in range(steps)])
    losses = losses.float().cpu().numpy()
    t2 = time.perf_counter()
    n = len(losses)
    nodes = task.args.train_batch_size * n
    return {"epoch": epoch, "steps": n, "loss_first": float(losses[0]),
            "loss_last": float(losses[-1]), "losses_finite": bool(np.isfinite(losses).all()),
            "refresh_ms": (t1 - t0) * 1e3, "refresh_peak_bytes": refresh_peak,
            "ms_per_step": (t2 - t1) * 1e3 / max(n, 1),
            "nodes_per_s": nodes / (t2 - t0), "losses": losses.tolist()}


def smoke(opts: Dict[str, Any], emit=None) -> Dict[str, Any]:
    """The whole smoke in this process (one rank of a group, or alone);
    each result goes to ``emit`` as it comes. Returns them all."""
    out: Dict[str, Any] = {}

    def put(key, row):
        out[key] = row
        if emit is not None:
            emit({"phase": key, **row})

    mesh = tmesh.current_mesh(opts["device"])
    t0 = time.perf_counter()
    art = make_dataset(opts["num_nodes"], opts["avg_degree"])
    gen_s = time.perf_counter() - t0
    args = train_args(opts["batch"], feat_tables_dtype=opts["feat_tables_dtype"],
                      shard_feat_tables=opts["shard_feat_tables"],
                      shard_graph_tables=opts["shard_graph_tables"],
                      num_devices=mesh.size if mesh.distributed else None)
    task, build_s = timed_build(art, args, opts["device"])
    put("scale_setup", {"num_nodes": art.num_nodes, "max_degree": art.graph.max_degree,
                        "rank": mesh.rank, "ranks": mesh.size, "generation_s": gen_s,
                        "task_build_s": build_s, "fusion": task.config.fusion_strategy,
                        **table_bytes(task)})
    chunk = task.refresh["chunk"]
    put("scale_refresh_budget", {"rank": mesh.rank, **task.refresh,
                                 "chunks": -(-task.sampling.num_total // chunk),
                                 "chunk_transient": chunk_transient(
                                     task, min(chunk, task.sampling.num_total))})
    epochs = [run_epoch(task, e, opts.get("steps")) for e in range(opts["epochs"] + 1)]
    for row in epochs:
        put(f"scale_epoch{row['epoch']}", {k: v for k, v in row.items() if k != "losses"})
    rates = [r["nodes_per_s"] for r in epochs[1:]] or [epochs[0]["nodes_per_s"]]
    t0 = time.perf_counter()
    metrics = task.evaluate("valid")
    put("scale_result", {"median_nodes_per_s": statistics.median(rates),
                         "evaluate_ms": (time.perf_counter() - t0) * 1e3, **metrics,
                         **memory(task.device)})
    out["losses"] = [r["losses"] for r in epochs]
    return out


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--num-nodes", type=int, default=100_000)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--epochs", type=int, default=3, help="measured epochs after epoch 0")
    ap.add_argument("--steps", type=int, default=None,
                    help="stop each epoch after this many steps (a capacity run)")
    ap.add_argument("--avg-degree", type=int, default=16)
    ap.add_argument("--shard-feat-tables", action="store_true",
                    help="row-shard the frozen feature tables over the ranks")
    ap.add_argument("--shard-graph-tables", action="store_true",
                    help="row-shard the per-node graph tables over the ranks")
    ap.add_argument("--feat-tables-dtype", default=None,
                    choices=("float32", "bfloat16", "int8"),
                    help="table storage (default bf16 under the bf16 policy)")
    ap.add_argument("--num-devices", type=int, default=None,
                    help="data-parallel ranks (NCCL over cards, gloo on the CPU)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    ns = parse(argv)
    opts = vars(ns)

    def emit(obj):
        print(json.dumps(obj), flush=True)

    if ns.num_devices and ns.num_devices > 1:
        ranks = tmesh.launch(smoke, ns.num_devices, (opts,), device=ns.device)
        for r in ranks:
            for key, row in r.items():
                if key != "losses":
                    emit({"phase": key, **row})
        if ns.shard_feat_tables:  # each rank's block: total/N up to one padding row
            setup = [r["scale_setup"] for r in ranks]
            total = setup[0]["feat_total"]
            row_bytes = total / (ns.num_nodes + NUM_SPECIAL_NODES)
            even = all(abs(s["feat_rank"] - total / len(ranks)) <= row_bytes for s in setup)
            emit({"phase": "scale_sharded_bytes", "ok": even, "feat_total": total,
                  "feat_rank": [s["feat_rank"] for s in setup]})
            return 0 if even else 1
        return 0
    smoke(opts, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
