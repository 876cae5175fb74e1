"""Quality of int8 feature tables against bf16 ones in PMGT pre-training
(counterpart of ``tools/quality_int8_tables.py``).

    python -m pmgt_tpu_torch.tools.quality_int8_tables [--epochs 8] [--num-nodes 10834]

Trains PMGT twice from the same seed on the same synthetic dataset (TG's
10,834 nodes, feature widths 1536/768, average degree 16): once with bf16
feature tables (the default under the bf16 policy) and once with int8
row-quantized ones (``core/quant.py``). Both runs take every draw from
generators seeded alike (the epoch's contexts and pairs, each step's
dropout and corruption, the evaluation draw), so only the tables differ.
Each epoch prints its training loss and val-AUC; then one JSON line per
variant and the verdict line: int8 within ``EPOCH_TOL`` of bf16's val-AUC
every epoch and within ``FINAL_TOL`` after the last.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from pmgt_tpu_torch.core.config import TrainArgs
from pmgt_tpu_torch.data.synthetic import make_synthetic_dataset
from pmgt_tpu_torch.graph.container import NUM_SPECIAL_NODES
from pmgt_tpu_torch.tasks.pmgt_task import PMGTTask

EPOCH_TOL = 2e-3  # |val-AUC int8 - bf16| at every epoch
FINAL_TOL = 1e-3  # ... and after the last epoch


def make_dataset(num_nodes: int):
    """The JAX tool's dataset (tools/quality_int8_tables.py:71-74)."""
    return make_synthetic_dataset(num_nodes=num_nodes, num_users=100, feat_dims=(1536, 768),
                                  interactions_per_user=2, avg_degree=16, seed=0)


def train_args(dtype: str, epochs: int, batch: int) -> TrainArgs:
    """tools/quality_int8_tables.py:29-37."""
    return TrainArgs(
        model_name="PMGT", dataset_name="q", seed=0, num_epochs=epochs,
        train_batch_size=batch, test_batch_size=batch, lr=1e-4,
        mp_enabled=True, gradient_max_norm=5.0,
        extra=dict(hidden_size=128, intermediate_size=128, num_hidden_layers=5,
                   feat_tables_dtype=dtype),
    )


def run(art, dtype: str, epochs: int, batch: int, device: str = "cuda") -> Dict[str, Any]:
    """Train ``epochs`` epochs with ``dtype`` tables on the JAX tool's 90/10
    node split (``default_rng(0).permutation``); per-epoch val-AUC and mean
    training loss."""
    n = art.num_nodes
    nodes = np.arange(NUM_SPECIAL_NODES, n + NUM_SPECIAL_NODES, dtype=np.int32)
    perm = np.random.default_rng(0).permutation(n)
    split = int(n * 0.9)
    task = PMGTTask(train_args(dtype, epochs, batch), art, nodes[perm[:split]],
                    nodes[perm[split:]], device=device)
    aucs: List[float] = []
    losses: List[float] = []
    t0 = time.time()
    for epoch in range(epochs):
        epoch_losses = task.train_epoch(epoch).float().cpu().numpy()
        aucs.append(task.evaluate("valid")["val/auc"])
        losses.append(float(np.mean(epoch_losses)))
        print(f"[{dtype}] epoch {epoch}: loss {losses[-1]:.4f} val_auc {aucs[-1]:.4f}",
              flush=True)
    out = {"dtype": dtype, "val_auc": aucs, "train_loss": losses,
           "wall_s": round(time.time() - t0, 1)}
    print(json.dumps(out), flush=True)
    return out


def verdict(bf16: Dict[str, Any], int8: Dict[str, Any]) -> Dict[str, Any]:
    """The final AUCs and their delta (as the JAX tool prints them), the
    largest per-epoch gap, and whether both are within their bounds."""
    gaps = [abs(a - b) for a, b in zip(int8["val_auc"], bf16["val_auc"], strict=True)]
    delta = int8["val_auc"][-1] - bf16["val_auc"][-1]
    return {"final_auc_bf16": bf16["val_auc"][-1], "final_auc_int8": int8["val_auc"][-1],
            "delta": round(delta, 5), "max_epoch_gap": max(gaps),
            "epoch_tol": EPOCH_TOL, "final_tol": FINAL_TOL,
            "ok": bool(max(gaps) <= EPOCH_TOL and abs(delta) <= FINAL_TOL)}


def parse(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--num-nodes", type=int, default=10834)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ns = parse(argv)
    art = make_dataset(ns.num_nodes)
    res = [run(art, d, ns.epochs, ns.batch, ns.device) for d in ("bfloat16", "int8")]
    v = verdict(*res)
    print(json.dumps(v), flush=True)
    return 0 if v["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
