"""PMGT_NCF's per-epoch validation curve, JAX against the port (CPU, small
size): does the port's arm of ``QUALITY_TORCH_TG_PMGT_NCF.json`` peak and
fall over the epochs as the JAX arm does?

    python tests/torch_port_pmgt_ncf_curves.py --out pmgt_ncf_curves.json

Both packages train the ``pmgt_ncf`` arm of ``tools/validate_pipeline.py``
(``:216-240``: NeuMF-end with the default PMGT encoder as the item tower,
lr 1e-3, early stopping on validation N@20 after 4 epochs) on the same
synthetic dataset over a few seeds, and each run's validation N@20 and
R@20 are read back from its registry an epoch at a time, with its test
metrics. The JAX runs need the JAX package, so this is a script beside the
tests (it imports both) rather than part of the port.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import tempfile

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from pmgt_tpu.core.config import TrainArgs as JTrainArgs  # noqa: E402
from pmgt_tpu.data.synthetic import make_synthetic_dataset as jmake  # noqa: E402
from pmgt_tpu.tasks import pmgt_ncf_task as jtask  # noqa: E402
from pmgt_tpu.train.registry import RunRegistry as JRegistry  # noqa: E402
from pmgt_tpu_torch.data.synthetic import make_synthetic_dataset as tmake  # noqa: E402
from pmgt_tpu_torch.tasks import pmgt_ncf_task as ttask  # noqa: E402
from pmgt_tpu_torch.tools import validate_pipeline as vp  # noqa: E402
from pmgt_tpu_torch.train.registry import RunRegistry as TRegistry  # noqa: E402

CURVES = ("val/n20", "val/r20")


def curve(run) -> dict:
    metrics = run.metrics()
    return {k: [m["value"] for m in metrics if m["name"] == k] for k in CURVES}


def jax_arm(args, art, registry, name):
    """tools/validate_pipeline.py:231-238."""
    a = JTrainArgs(**{k: v for k, v in dataclasses.asdict(args).items() if k != "extra"},
                   extra=dict(args.extra))
    c = {"artifacts": art}
    jtask.check_args(a)
    jtask.init_run(a)
    jtask.init_dataloader(a, c)
    jtask.init_model(a, c)
    run = registry.create_run(name, a.to_dict())
    jtask.train(a, c, registry, run)
    return jtask.test(a, c, registry, run), run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--num-nodes", type=int, default=600)
    ap.add_argument("--num-users", type=int, default=600)
    ap.add_argument("--interactions-per-user", type=int, default=12)
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--out", default="pmgt_ncf_curves.json")
    cli = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    torch.set_num_threads(2)
    work = tempfile.mkdtemp(prefix="pmgt_ncf_curves_")
    data = dict(num_nodes=cli.num_nodes, num_users=cli.num_users, feat_dims=(64, 32),
                interactions_per_user=cli.interactions_per_user, seed=42)
    jart, tart = jmake(**data), tmake(**data)
    assert np.array_equal(jart.train_pairs, tart.train_pairs)
    jreg, treg = JRegistry(f"{work}/jlogs"), TRegistry(f"{work}/tlogs")
    seeds = [int(s) for s in cli.seeds.split(",")]
    runs = {"port": {}, "jax": {}}
    for seed in seeds:
        ns = vp.parse(["--out", work, "--downstream-epochs", str(cli.epochs),
                       "--downstream-seed", str(seed), "--device", "cpu"])
        args = vp.pmgt_ncf_args(ns)
        tres, trun = vp.run_task(ttask, args, tart, treg, f"pmgt_ncf_s{seed}", "cpu")
        jres, jrun = jax_arm(vp.pmgt_ncf_args(ns), jart, jreg, f"pmgt_ncf_s{seed}")
        runs["port"][str(seed)] = {"test": tres, **curve(trun)}
        runs["jax"][str(seed)] = {"test": {k: float(v) for k, v in jres.items()}, **curve(jrun)}
        print(json.dumps({side: r[str(seed)] for side, r in runs.items()}), flush=True)
    summary = {}
    for side, by_seed in runs.items():
        n20 = [r["val/n20"] for r in by_seed.values()]
        summary[side] = {
            "peak_epoch": [int(np.argmax(c)) for c in n20],
            "epochs_run": [len(c) for c in n20],
            "test/n20": vp.mean_std([r["test"]["test/n20"] for r in by_seed.values()]),
            "val/n20 by epoch": [vp.mean_std([c[e] for c in n20 if len(c) > e])
                                 for e in range(max(map(len, n20)))],
        }
    out = {"data": data, "seeds": seeds, "epochs": cli.epochs, "runs": runs,
           "summary": summary}
    with open(cli.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
