"""NeuMF-pre bisect (counterpart of ``tools/neumf_pre_bisect.py``): is the
tower fusion right, and does NeuMF-pre need the published learning rate?

    python -m pmgt_tpu_torch.tools.neumf_pre_bisect [--shape TG] [--lrs 1e-3,1e-4:36]

GMF and MLP train at lr 1e-3; NeuMF-pre is fused from their best
checkpoints at α 0.5 and its fused initialisation is evaluated on the test
split with no fine-tuning (``neumf_pre_init_only``); then NeuMF-pre is
fine-tuned at each rung of the ladder ``--lrs`` ("lr" or "lr:epochs").
Every run goes through the task API in this process. ``--shape`` takes
the published shape at its calibrated signal, else the small synthetic
set of the JAX tool. ``compare_to_jax`` holds a report against
``QUALITY_NEUMF_PRE_BISECT_TG.json`` with bounds fixed before the port's
first run at TG.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from typing import Any, Dict, Optional, Sequence

from pmgt_tpu_torch.core.config import TrainArgs
from pmgt_tpu_torch.data.synthetic import (
    CALIBRATED_SIGNAL,
    make_published_shape_dataset,
    make_synthetic_dataset,
)
from pmgt_tpu_torch.tasks import ncf_task
from pmgt_tpu_torch.tools import validate_pipeline as vp
from pmgt_tpu_torch.train.registry import RunRegistry

BASE = dict(factor_num=64, num_layers=2, num_ng=1, max_sample_items=500)  # :100

# the comparison with the JAX package's record (bounds fixed up front)
N20_TOL = 0.01  # each arm's test/n20 against JAX's (one run each side)
INIT_SLACK = 0.005  # init-only >= max(GMF, MLP) - this
COLLAPSE = 0.02  # the lr 1e-3 fine-tune below init-only - this


def ncf_args(ns: argparse.Namespace, model_name: str, lr: float, num_epochs: int,
             extra: Dict[str, Any]) -> TrainArgs:
    """tools/neumf_pre_bisect.py:78-85 (``run``) and :108-113 (the fused
    initialisation, ``num_epochs`` 0 at lr 1e-4)."""
    return TrainArgs(
        model_name=model_name, dataset_name="Q", seed=0, num_epochs=num_epochs,
        train_batch_size=256, test_batch_size=512, lr=lr, decay=0.0,
        early=4, early_criterion="n20", valid_size=0.2, mp_enabled=True,
        gradient_max_norm=5.0, ckpt_interval=1_000_000, log_dir=f"{ns.out}/logs",
        extra=dict(extra),
    )


def fused_extra(gmf_run_id: str, mlp_run_id: str) -> Dict[str, Any]:
    """tools/neumf_pre_bisect.py:104: NeuMF-pre from the two towers at α 0.5."""
    return dict(BASE, gmf_run_id=gmf_run_id, mlp_run_id=mlp_run_id, alpha=0.5)


def ladder(lrs: str, epochs: int):
    """tools/neumf_pre_bisect.py:124-134: (name, lr, epochs) of each rung of
    ``lrs``, "lr" (``epochs``) or "lr:epochs"."""
    out = []
    for lr_s in lrs.split(","):
        n = epochs
        if ":" in lr_s:
            lr_s, ep = lr_s.split(":")
            n = int(ep)
        out.append((f"neumf_pre_lr{lr_s}_e{n}", float(lr_s), n))
    return out


def compare_to_jax(report: Dict[str, Any], jax: Dict[str, Any]) -> Dict[str, Any]:
    """Hold a report against the JAX record:

    - each arm the JAX record has: test/n20 within 0.01 of JAX's;
    - the fusion is right: init-only >= max(GMF, MLP) − 0.005;
    - the protocol finding: the lr 1e-3 fine-tune collapses below
      init-only − 0.02 (JAX: 0.1782 against 0.2583).

    Returns the rows, ``ok`` (every row ok, at least one arm compared) and
    the missed checks."""
    n20 = report["results_n20"]
    rows = [vp._row(f"{arm} test/n20", n20[arm], jax["full"][arm]["test/n20"], N20_TOL)
            for arm in sorted(jax["full"]) if arm in n20]
    compared = bool(rows)
    init = n20["neumf_pre_init_only"]
    floor = max(n20["gmf"], n20["mlp"]) - INIT_SLACK
    rows.append({"check": "init-only >= max(gmf, mlp) - 0.005", "port": init, "floor": floor,
                 "ok": bool(init >= floor)})
    collapsed = [k for k in n20 if k.startswith("neumf_pre_lr1e-3_")]
    for arm in collapsed:
        rows.append({"check": f"{arm} < init-only - 0.02", "port": n20[arm],
                     "ceiling": init - COLLAPSE, "ok": bool(n20[arm] < init - COLLAPSE)})
    ok = compared and bool(collapsed) and all(r["ok"] for r in rows)
    return {"rows": rows, "ok": ok, "misses": [r["check"] for r in rows if not r["ok"]]}


def make_dataset(ns: argparse.Namespace):
    """(artifacts, signal): ``--shape`` at its calibrated signal, else the
    JAX tool's small synthetic set (tools/neumf_pre_bisect.py:55-72)."""
    if ns.shape:
        signal = CALIBRATED_SIGNAL[ns.shape]
        return make_published_shape_dataset(ns.shape, seed=42, signal=signal), signal
    return make_synthetic_dataset(num_nodes=ns.num_nodes, num_users=ns.num_users,
                                  num_clusters=12, feat_dims=(64, 32), interactions_per_user=15,
                                  avg_degree=10, seed=42), None


def run(ns: argparse.Namespace, art, signal: Optional[float] = None,
        argv: Sequence[str] = ()) -> Dict[str, Any]:
    """The towers, the fused initialisation and the ladder; writes
    ``--report`` when given and returns the report: ``full`` (the JAX
    tool's dict: each arm's lr and test metrics), ``results_n20``,
    ``provenance`` and the signal."""
    os.makedirs(ns.out, exist_ok=True)
    t0 = time.perf_counter()
    registry = RunRegistry(f"{ns.out}/logs")
    full: Dict[str, Dict[str, float]] = {}

    def train(name, model_name, lr, epochs, extra):
        res, r = vp.run_task(ncf_task, ncf_args(ns, model_name, lr, epochs, extra), art,
                             registry, name, ns.device)
        full[name] = {"lr": lr, **res}
        print(f"== {name}: {res}", flush=True)
        return r

    gmf_run = train("gmf", "GMF", 1e-3, ns.epochs, BASE)
    mlp_run = train("mlp", "MLP", 1e-3, ns.epochs, BASE)
    pre = fused_extra(gmf_run.run_id, mlp_run.run_id)
    ctx: Dict[str, Any] = {"artifacts": art, "device": ns.device}
    a0 = ncf_args(ns, "NeuMF-pre", 1e-4, 0, pre)
    ncf_task.check_args(a0)
    ncf_task.init_run(a0)
    ncf_task.init_dataloader(a0, ctx)
    ncf_task.init_model(a0, ctx)
    t = ctx["task"].evaluate(split="test")
    full["neumf_pre_init_only"] = {"lr": 0.0, **t}
    print("== neumf_pre_init_only:", t, flush=True)
    for name, lr, epochs in ladder(ns.lrs, ns.epochs):
        train(name, "NeuMF-pre", lr, epochs, pre)

    report = {"signal": signal, "provenance": vp.provenance(argv),
              "results_n20": {k: v["test/n20"] for k, v in full.items()}, "full": full,
              "seconds": time.perf_counter() - t0}
    print(json.dumps(report, indent=2), flush=True)
    print(f"\nmax(GMF, MLP) n20 = {max(full['gmf']['test/n20'], full['mlp']['test/n20']):.4f}")
    if ns.report:
        with open(ns.report, "w") as f:
            json.dump(report, f, indent=2)
    return report


def parse(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--shape", choices=["VG", "TG"], default=None)
    ap.add_argument("--num-nodes", type=int, default=800)
    ap.add_argument("--num-users", type=int, default=600)
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--lrs", default="1e-3,1e-4")
    ap.add_argument("--out", default="outputs/neumf_pre_bisect")
    ap.add_argument("--report", default=None)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    logging.basicConfig(level=logging.INFO)
    ns = parse(argv)
    art, signal = make_dataset(ns)
    run(ns, art, signal, argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
