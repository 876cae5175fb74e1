"""DCN gate sensitivity (counterpart of ``tools/dcn_sensitivity.py``): can
the quality gate's DCN arm see a loss of fidelity in the PMGT export?

    python -m pmgt_tpu_torch.tools.dcn_sensitivity --shape TG [--emb-path E] [--freeze]

Known losses are injected into the export that feeds the gate's DCN arm,
and the arm's test AUC is read per downstream seed:

- ``plain``: no export (the gate's baseline arm);
- ``real``: the export (the gate's treatment arm);
- ``nerf50``: 0.5·emb + 0.5·emb[perm], half of each row replaced by
  another node's (``perm`` from ``default_rng(0)``);
- ``zero``: zeros.

The verdict: a half-lift regression is detectable when the mean of the
paired per-seed contrast real − nerf50 exceeds twice its spread over the
seeds. ``--freeze`` freezes the injected table (the detector protocol):
the arm then reads the export's content instead of its scale.

The PMGT stage (skipped with ``--emb-path``) trains and exports through
the task API in this process; each downstream seed then runs the plain arm
and the three variants in a process of its own, all seeds side by side on
the one card. ``compare_to_jax`` holds a record against the JAX package's
(``DCN_SENSITIVITY_TG.json``, ``..._FROZEN.json``) with bounds fixed
before the port's first run at TG.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import statistics
import sys
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np

from pmgt_tpu_torch.core.config import TrainArgs
from pmgt_tpu_torch.data.artifacts import load_artifacts, save_native
from pmgt_tpu_torch.data.synthetic import CALIBRATED_SIGNAL, make_published_shape_dataset
from pmgt_tpu_torch.tasks import dcn_task, pmgt_task
from pmgt_tpu_torch.tools import cli_runner as cr
from pmgt_tpu_torch.tools import validate_pipeline as vp
from pmgt_tpu_torch.train.registry import RunRegistry

VARIANTS = ("real", "nerf50", "zero")
ARMS = ("plain",) + VARIANTS
DATASET = "Q"  # the dataset's name under <out>/data, where the seed processes read it

# the comparison with the JAX package's records (bounds fixed up front)
SIGMAS = 3.0  # an arm's mean AUC within max(SIGMAS * std, AUC_FLOOR) of JAX's
AUC_FLOOR = 0.005


def pmgt_args(ns: argparse.Namespace) -> TrainArgs:
    """tools/dcn_sensitivity.py:81-90."""
    return TrainArgs(
        model_name="PMGT", dataset_name="Q", seed=0, num_epochs=ns.pmgt_epochs,
        train_batch_size=256, test_batch_size=512, lr=1e-4, decay=1e-2,
        early=5, early_criterion="auc", valid_size=0.1, mp_enabled=True,
        gradient_max_norm=5.0, ckpt_interval=1_000_000, log_dir=f"{ns.out}/logs",
        extra=dict(hidden_size=128, intermediate_size=128, num_hidden_layers=5),
    )


def dcn_args(ns: argparse.Namespace, seed: int, emb_path: Optional[str],
             log_dir: str) -> TrainArgs:
    """tools/dcn_sensitivity.py:119-138 (``run_dcn``): the gate's DCN
    arguments; with an export, normalised and frozen with ``--freeze``."""
    extra = dict(factor_num=32, deep_net_num_layers=2, cross_net_num_layers=3,
                 num_ng=1, max_sample_items=5, emb_dropout=0.2, use_layer_norm=True)
    if emb_path:
        extra.update(item_init_emb_path=emb_path, normalize_item_init_emb=True,
                     freeze_item_init_emb=ns.freeze)
    return TrainArgs(
        model_name="DCN", dataset_name="Q", seed=seed, num_epochs=ns.downstream_epochs,
        train_batch_size=256, test_batch_size=512, lr=1e-3, decay=1e-3,
        early=4, early_criterion="auc", valid_size=0.2, mp_enabled=True,
        gradient_max_norm=5.0, ckpt_interval=1_000_000, log_dir=log_dir, extra=extra,
    )


def variants(emb: np.ndarray) -> Dict[str, np.ndarray]:
    """tools/dcn_sensitivity.py:104-117: the three exports, float32."""
    perm = np.random.default_rng(0).permutation(len(emb))
    arrays = {"real": emb, "nerf50": 0.5 * emb + 0.5 * emb[perm], "zero": np.zeros_like(emb)}
    return {k: v.astype(np.float32) for k, v in arrays.items()}


def analyse(auc: Dict[str, float], seeds: Sequence[int]) -> Dict[str, Any]:
    """tools/dcn_sensitivity.py:158-195 on ``auc`` ({"<arm>_s<seed>":
    test AUC}): each variant's lift over plain in AUC points per seed and
    its mean, the paired contrast real − nerf50, its sample σ and the
    verdict, rounded as the JAX record. σ of one seed is 0, as
    ``validate_pipeline.mean_std`` has it (NumPy's ddof=1 gives NaN)."""
    lifts = {v: [(auc[f"{v}_s{s}"] - auc[f"plain_s{s}"]) * 100 for s in seeds]
             for v in VARIANTS}
    contrast = [(auc[f"real_s{s}"] - auc[f"nerf50_s{s}"]) * 100 for s in seeds]
    sigma = vp.mean_std(contrast)["std"]
    mean = float(np.mean(contrast))
    return {
        "auc": {f"{a}_s{s}": round(auc[f"{a}_s{s}"], 5) for s in seeds for a in ARMS},
        "lift_pts": {k: [round(x, 3) for x in v] for k, v in lifts.items()},
        "mean_lift_pts": {k: round(float(np.mean(v)), 3) for k, v in lifts.items()},
        "real_minus_nerf50_pts": [round(x, 3) for x in contrast],
        "contrast_mean_pts": round(mean, 3),
        "contrast_sigma_pts": round(sigma, 3),
        "half_lift_regression_detectable_at_2sigma": bool(mean > 2 * sigma),
    }


def compare_to_jax(report: Dict[str, Any], jax: Dict[str, Any]) -> Dict[str, Any]:
    """Hold a report against the JAX record of the same protocol:

    - each arm's mean test AUC over the seeds within max(3σ, 0.005) of
      JAX's mean (σ the port's sample σ over its seeds);
    - the ``detectable`` verdict equal to JAX's;
    - with ``freeze``, the ``zero`` arm's AUC exactly 0.5 at every seed:
      a zero row stays zero under the row normalisation and, frozen,
      scores every item alike.

    The port's AUCs are the unrounded ``auc_exact`` where the report has
    them. Returns the rows, ``ok`` (every row ok) and the missed checks."""
    auc = report.get("auc_exact", report["auc"])
    rows = []
    for arm in ARMS:
        port = [v for k, v in auc.items() if k.startswith(f"{arm}_s")]
        ref = [v for k, v in jax["auc"].items() if k.startswith(f"{arm}_s")]
        st = vp.mean_std(port)
        rows.append(vp._row(f"{arm} mean test/auc", st["mean"], statistics.fmean(ref),
                            max(SIGMAS * st["std"], AUC_FLOOR), std=st["std"], seeds=st["n"]))
    key = "half_lift_regression_detectable_at_2sigma"
    rows.append({"check": "detectable verdict equals JAX's", "port": report[key],
                 "jax": jax[key], "ok": report[key] == jax[key]})
    if report.get("freeze"):
        zero = [v for k, v in auc.items() if k.startswith("zero_s")]
        rows.append({"check": "frozen zero arm test/auc == 0.5 at every seed", "port": zero,
                     "ok": bool(zero) and all(v == 0.5 for v in zero)})
    return {"rows": rows, "ok": all(r["ok"] for r in rows),
            "misses": [r["check"] for r in rows if not r["ok"]]}


# ----------------------------------------------------------------------
# stages
# ----------------------------------------------------------------------

def make_dataset(ns: argparse.Namespace):
    """(artifacts, signal): the published shape at its calibrated signal
    (or ``--signal``), data seed 42 (tools/dcn_sensitivity.py:68-69)."""
    signal = ns.signal if ns.signal is not None else CALIBRATED_SIGNAL[ns.shape]
    return make_published_shape_dataset(ns.shape, seed=42, signal=signal), signal


def seed_arms(ns: argparse.Namespace, seed: int) -> Dict[str, float]:
    """One downstream seed in this process: the plain arm, then each
    variant, on the dataset and exports ``run`` wrote under ``--out``;
    {"<arm>_s<seed>": test AUC}, also written to ``<out>/seed<k>.json``."""
    art = load_artifacts(os.path.join(ns.out, "data"), DATASET)
    log_dir = os.path.join(ns.out, f"seed{seed}", "logs")
    registry = RunRegistry(log_dir)
    auc = {}
    for arm in ARMS:
        emb = None if arm == "plain" else os.path.join(ns.out, f"emb_{arm}.npy")
        tag = f"dcn_{arm}_s{seed}"
        res, _ = vp.run_task(dcn_task, dcn_args(ns, seed, emb, log_dir), art, registry, tag,
                             ns.device)
        print(f"== {tag}: {res}", flush=True)
        auc[f"{arm}_s{seed}"] = res["test/auc"]
    with open(os.path.join(ns.out, f"seed{seed}.json"), "w") as f:
        json.dump(auc, f)
    return auc


def run_seeds(ns: argparse.Namespace, seeds: Sequence[int]) -> Dict[str, float]:
    """``seed_arms`` for every seed, each in a process of its own, all at
    once (``cli_runner.run_processes``); the union of their AUCs."""
    jobs = {}
    for k in seeds:
        argv = [sys.executable, "-m", "pmgt_tpu_torch.tools.dcn_sensitivity",
                "--worker-seed", str(k), "--out", ns.out, "--downstream-epochs",
                str(ns.downstream_epochs), "--device", ns.device]
        argv += ["--freeze"] if ns.freeze else []
        jobs[f"DCN seed {k}"] = (argv, os.path.join(ns.out, f"seed{k}.log"))
    cr.run_processes(jobs)
    auc = {}
    for k in seeds:
        with open(os.path.join(ns.out, f"seed{k}.json")) as f:
            auc.update(json.load(f))
    return auc


def run(ns: argparse.Namespace, art, signal: Optional[float],
        argv: Sequence[str] = ()) -> Dict[str, Any]:
    """The PMGT stage (unless ``--emb-path``), the variants, every seed's
    four arms and the analysis; writes ``--report`` when given and returns
    the report (the JAX tool's keys, ``provenance`` beside them)."""
    os.makedirs(ns.out, exist_ok=True)
    t0 = time.perf_counter()
    print(f"dataset: {art.num_nodes} nodes, {art.num_users} users, signal {signal}", flush=True)
    save_native(os.path.join(ns.out, "data", DATASET), art)
    pmgt = None
    if ns.emb_path:
        emb_path = ns.emb_path
        print(f"reusing embeddings from {emb_path}", flush=True)
    else:
        emb_path = f"{ns.out}/node_feat_128dim.npy"
        pmgt, _ = vp.run_task(pmgt_task, pmgt_args(ns), art, RunRegistry(f"{ns.out}/logs"),
                              "PMGT", ns.device, export_path=emb_path)
        print("PMGT:", pmgt, flush=True)
    for name, arr in variants(np.load(emb_path)).items():
        np.save(os.path.join(ns.out, f"emb_{name}.npy"), arr)
    seeds = [int(s) for s in ns.seeds.split(",")]
    auc = run_seeds(ns, seeds)
    prov = vp.provenance(argv)
    report = {
        "what": "DCN gate sensitivity: known fidelity nerfs injected into the PMGT "
                "embeddings feeding the gate's DCN arm",
        "shape": ns.shape, "signal": signal, "freeze": ns.freeze,
        "git_commit": prov["commit"], "provenance": prov, "pmgt": pmgt,
        **analyse(auc, seeds), "auc_exact": auc, "seconds": time.perf_counter() - t0,
    }
    print(json.dumps(report, indent=1), flush=True)
    if ns.report:
        with open(ns.report, "w") as f:
            json.dump(report, f, indent=1)
    return report


def parse(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", choices=["VG", "TG"], default="TG")
    ap.add_argument("--signal", type=float, default=None)
    ap.add_argument("--pmgt-epochs", type=int, default=8)
    ap.add_argument("--downstream-epochs", type=int, default=12)
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--emb-path", default=None,
                    help="reuse a previously exported PMGT embedding npy (skips the "
                    "pretrain stage)")
    ap.add_argument("--freeze", action="store_true",
                    help="freeze the injected embeddings in the variant arms "
                    "(--freeze-item-init-emb): the detector protocol")
    ap.add_argument("--out", default="outputs/dcn_sensitivity")
    ap.add_argument("--report", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--worker-seed", type=int, default=None,
                    help="internal: run one seed's four arms on the data under --out")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None, art=None) -> int:
    """The tool; ``art`` replaces the published-shape dataset (tests)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    logging.basicConfig(level=logging.INFO)
    ns = parse(argv)
    if ns.worker_seed is not None:
        seed_arms(ns, ns.worker_seed)
        return 0
    art, signal = (art, None) if art is not None else make_dataset(ns)
    run(ns, art, signal, argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
