"""End-to-end quality of the port: PMGT pre-training, the export, then
every published downstream family with and without the PMGT item
embeddings (counterpart of ``tools/validate_pipeline.py``).

    python -m pmgt_tpu_torch.tools.validate_pipeline --shape VG [--out DIR]

The stages, each through the port's task API (``check_args``,
``init_run``, ``init_dataloader``, ``init_model``, ``train``, ``test``,
``inference``) with the JAX tool's arguments value for value:

1. PMGT pre-training (hidden 128, 5 layers, bf16 policy) and the export of
   its per-node embeddings to ``<out>/node_feat_128dim.npy``;
2. NeuMF-end without (``ncf_plain``) and with (``ncf_pmgt``) the export;
3. GMF and MLP, then NeuMF-pre fused from their best checkpoints;
4. PMGT_NCF (opt-in: ``--families ...,pmgt_ncf``);
5. DCN without (``dcn_plain``) and with (``dcn_pmgt``) the export.

``<out>/results.json`` has the JAX tool's keys and metric names, and its
``provenance`` also names the card (``nvidia-smi``'s name and power limit).
The data is the port's synthetic dataset (seed 42): ``--shape VG|TG`` the
published scale and sparsity with the calibrated signal, else
``--num-nodes`` × ``--num-users``. ``--emb-path`` skips pre-training and
reuses an export (the graph and features do not depend on ``--signal``).

``quality_record`` gathers the results of several downstream seeds on one
export and ``compare_to_jax`` holds them against the JAX package's record
of the same shape (``QUALITY_VG.json``, ``QUALITY_TG.json``) with the
bounds below, fixed before the port's first run at the published shapes.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import logging
import os
import statistics
import subprocess
import sys
from typing import Any, Dict, List, Optional, Sequence

from pmgt_tpu_torch.core.config import TrainArgs
from pmgt_tpu_torch.data.synthetic import (
    CALIBRATED_SIGNAL,
    make_published_shape_dataset,
    make_synthetic_dataset,
)
from pmgt_tpu_torch.tasks import pmgt_task
from pmgt_tpu_torch.train.registry import RunRegistry

logger = logging.getLogger("pmgt_tpu_torch")

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FAMILIES = "neumf,dcn,gmf,mlp,neumf_pre"
DATA_SEED = 42

# ----------------------------------------------------------------------
# the comparison with the JAX package's records (bounds fixed up front)
# ----------------------------------------------------------------------
RANK_ARMS = ("ncf_plain", "ncf_pmgt", "gmf", "mlp", "neumf_pre", "pmgt_ncf")
RANK_METRICS = ("test/n20", "test/r20")
AUC_ARMS = ("dcn_plain", "dcn_pmgt")
SIGMAS = 3.0  # |mean - JAX| <= max(SIGMAS * std, floor)
RANK_FLOOR = 0.01  # N@20, R@20
AUC_FLOOR = 0.005  # DCN test AUC
N20_LIFT_TOL = 0.05  # NeuMF-end's relative N@20 lift: ±5 points
AUC_LIFT_TOL = 0.01  # DCN's AUC lift: ±1.0 point
NEUMF_PRE_SLACK = 0.005  # NeuMF-pre N@20 >= max(GMF, MLP) - this
PMGT_AUC_TOL = 0.01  # pre-training's best val-AUC


def jax_record(shape: str, repo: str = REPO, name: Optional[str] = None) -> Dict[str, Any]:
    """The JAX package's quality record at ``shape`` (or the file
    ``name``), read as data."""
    with open(os.path.join(repo, name or f"QUALITY_{shape.upper()}.json"), encoding="utf-8") as f:
        return json.load(f)


def mean_std(values: Sequence[float]) -> Dict[str, float]:
    """Mean and sample standard deviation (0 for one value)."""
    values = [float(v) for v in values]
    return {"mean": statistics.fmean(values),
            "std": statistics.stdev(values) if len(values) > 1 else 0.0, "n": len(values)}


def _row(check: str, port: float, jax: float, bound: float, **extra) -> Dict[str, Any]:
    diff = port - jax
    return {"check": check, "port": port, "jax": jax, "diff": diff, "bound": bound,
            "ok": bool(abs(diff) <= bound), **extra}


def compare_to_jax(seeds: Sequence[Dict[str, Any]], jax: Dict[str, Any],
                   pmgt: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
    """Hold the port's results over downstream seeds (``seeds``: one
    results dict each, on one export) against the JAX record ``jax``:

    - each arm's mean within max(3σ, 0.01) of JAX's N@20 and R@20
      (``RANK_ARMS``, PMGT_NCF among them), within max(3σ, 0.005) of its
      test AUC (``AUC_ARMS``);
    - NeuMF-end's N@20 lift (ncf_pmgt / ncf_plain - 1, averaged over the
      seeds) within ±0.05 of JAX's; DCN's AUC lift within ±0.01 of JAX's;
    - NeuMF-pre's mean N@20 at least max(GMF, MLP) - 0.005 (the port's own);
    - PMGT's best val-AUC (``pmgt``) within 0.01 of JAX's, where JAX has one.

    σ is the port's sample standard deviation over the seeds. A check
    whose arm is missing on either side is left out. Returns the rows and
    ``ok`` (every row ok, and at least one row)."""
    rows: List[Dict[str, Any]] = []

    def stats(arm, metric):
        vals = [s[arm][metric] for s in seeds if metric in s.get(arm, {})]
        return mean_std(vals) if vals else None

    for arms, metrics, floor in ((RANK_ARMS, RANK_METRICS, RANK_FLOOR),
                                 (AUC_ARMS, ("test/auc",), AUC_FLOOR)):
        for arm in arms:
            for metric in metrics:
                st = stats(arm, metric)
                if st is None or metric not in jax.get(arm, {}):
                    continue
                rows.append(_row(f"{arm} {metric}", st["mean"], jax[arm][metric],
                                 max(SIGMAS * st["std"], floor), std=st["std"], seeds=st["n"]))
    for plain, pmgt_arm, metric, relative, tol in (
        ("ncf_plain", "ncf_pmgt", "test/n20", True, N20_LIFT_TOL),
        ("dcn_plain", "dcn_pmgt", "test/auc", False, AUC_LIFT_TOL),
    ):
        both = [s for s in seeds if plain in s and pmgt_arm in s]
        if not both or plain not in jax or pmgt_arm not in jax:
            continue

        def lift(p, q):
            return q / p - 1.0 if relative else q - p

        per_seed = [lift(s[plain][metric], s[pmgt_arm][metric]) for s in both]
        rows.append(_row(f"{pmgt_arm} over {plain} {metric} lift",
                         statistics.fmean(per_seed),
                         lift(jax[plain][metric], jax[pmgt_arm][metric]), tol,
                         per_seed=per_seed, relative=relative))
    pre, towers = stats("neumf_pre", "test/n20"), [stats(a, "test/n20") for a in ("gmf", "mlp")]
    if pre is not None and all(t is not None for t in towers):
        floor = max(t["mean"] for t in towers) - NEUMF_PRE_SLACK
        rows.append({"check": "neumf_pre test/n20 >= max(gmf, mlp) - 0.005",
                     "port": pre["mean"], "floor": floor, "ok": bool(pre["mean"] >= floor)})
    if pmgt is not None and "pmgt" in jax:
        rows.append(_row("pmgt best val/auc", pmgt["best"], jax["pmgt"]["best"], PMGT_AUC_TOL))
    return {"rows": rows, "ok": bool(rows) and all(r["ok"] for r in rows),
            "misses": [r["check"] for r in rows if not r["ok"]]}


def quality_record(shape: str, seed_results: Dict[int, Dict[str, Any]],
                   provenance: Dict[str, Any], pmgt: Optional[Dict[str, float]] = None,
                   repo: str = REPO, jax_name: Optional[str] = None) -> Dict[str, Any]:
    """The port's quality record at ``shape``: provenance, the PMGT
    pre-training's result, each downstream seed's results, their mean and
    standard deviation per arm and metric, and ``compare_to_jax`` against
    ``jax_name`` (default ``QUALITY_<shape>.json``; PMGT_NCF's record at TG
    is ``QUALITY_TG_PMGT_NCF.json``)."""
    seeds = [seed_results[k] for k in sorted(seed_results)]
    arms = [a for a in (*RANK_ARMS, *AUC_ARMS) if any(a in s for s in seeds)]
    values: Dict[str, Dict[str, List[float]]] = {}
    for s in seeds:
        for a in arms:
            for m, v in s.get(a, {}).items():
                values.setdefault(a, {}).setdefault(m, []).append(v)
    summary = {a: {m: mean_std(v) for m, v in ms.items()} for a, ms in values.items()}
    jax_name = jax_name or f"QUALITY_{shape.upper()}.json"
    jax = jax_record(shape, repo, jax_name)
    return {
        "provenance": provenance,
        "shape": shape.upper(),
        "signal": next((s["signal"] for s in seeds if "signal" in s), None),
        "pmgt": pmgt,
        "seeds": {str(k): {a: seed_results[k][a] for a in arms if a in seed_results[k]}
                  for k in sorted(seed_results)},
        "summary": summary,
        "jax_record": jax_name,
        "comparison": compare_to_jax(seeds, jax, pmgt),
    }


# ----------------------------------------------------------------------
# provenance
# ----------------------------------------------------------------------

def card_name() -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the first card (None
    without one)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def source_digest(repo: str = REPO) -> str:
    """sha256 over the port's sources (``pmgt_tpu_torch/``: Python, CUDA,
    C++), so a record can be tied to the code that made it when the copy
    it ran in has no git history."""
    h = hashlib.sha256()
    root = os.path.join(repo, "pmgt_tpu_torch")
    for d, dirs, names in sorted(os.walk(root)):
        dirs.sort()
        for n in sorted(names):
            if n.endswith((".py", ".cu", ".cuh", ".cpp")):
                path = os.path.join(d, n)
                h.update(os.path.relpath(path, repo).encode())
                with open(path, "rb") as f:
                    h.update(f.read())
    return h.hexdigest()


def provenance(argv: Sequence[str], repo: str = REPO) -> Dict[str, Any]:
    """The commit (``git rev-parse HEAD``, else ``PMGT_SOURCE_COMMIT``),
    the port's source digest, the argv and the card."""
    try:
        commit = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True,
                                text=True, cwd=repo, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        commit = ""
    return {"commit": commit or os.environ.get("PMGT_SOURCE_COMMIT"),
            "source_sha256": source_digest(repo), "argv": list(argv), "card": card_name()}


# ----------------------------------------------------------------------
# the stages' arguments (tools/validate_pipeline.py, value for value)
# ----------------------------------------------------------------------

def pmgt_args(ns: argparse.Namespace) -> TrainArgs:
    """tools/validate_pipeline.py:124-141."""
    return TrainArgs(
        model_name="PMGT", dataset_name="Q", seed=0, num_epochs=ns.pmgt_epochs,
        train_batch_size=256, test_batch_size=512, lr=1e-4, decay=1e-2,
        early=5, early_criterion="auc", valid_size=0.1, mp_enabled=True,
        gradient_max_norm=5.0, ckpt_interval=1_000_000, log_dir=f"{ns.out}/logs",
        extra=dict(hidden_size=128, intermediate_size=128, num_hidden_layers=5,
                   ctx_cache=not ns.no_ctx_cache),
    )


BASE_NCF = dict(factor_num=64, num_layers=2, num_ng=1, max_sample_items=500)  # :155


def ncf_args(ns: argparse.Namespace, model_name: str, extra: Dict[str, Any],
             lr: float = 1e-3) -> TrainArgs:
    """tools/validate_pipeline.py:157-178 (``run_ncf``)."""
    return TrainArgs(
        model_name=model_name, dataset_name="Q", seed=ns.downstream_seed,
        num_epochs=ns.downstream_epochs, train_batch_size=256, test_batch_size=512,
        lr=lr, decay=0.0, early=4, early_criterion="n20", valid_size=0.2,
        mp_enabled=True, gradient_max_norm=5.0, ckpt_interval=1_000_000,
        log_dir=f"{ns.out}/logs", extra=dict(extra),
    )


def with_export(extra: Dict[str, Any], emb_path: Optional[str]) -> Dict[str, Any]:
    """``extra`` with the PMGT export in the item table (:183-185, :258-259)."""
    if not emb_path:
        return dict(extra)
    return dict(extra, item_init_emb_path=emb_path, normalize_item_init_emb=True)


def neumf_pre_args(ns: argparse.Namespace, gmf_run_id: str, mlp_run_id: str) -> TrainArgs:
    """tools/validate_pipeline.py:192-214: the towers fused at α 0.5,
    fine-tuned at lr 1e-4, the fused initialisation evaluated first."""
    return ncf_args(ns, "NeuMF-pre", dict(BASE_NCF, gmf_run_id=gmf_run_id,
                                          mlp_run_id=mlp_run_id, alpha=0.5, eval_init=True),
                    lr=1e-4)


def pmgt_ncf_args(ns: argparse.Namespace) -> TrainArgs:
    """tools/validate_pipeline.py:216-240: NeuMF-end's arguments with the
    default PMGT encoder as the item tower."""
    return ncf_args(ns, "NeuMF-end", dict(BASE_NCF, hidden_size=128, intermediate_size=128,
                                          num_hidden_layers=5))


def dcn_args(ns: argparse.Namespace, emb_path: Optional[str]) -> TrainArgs:
    """tools/validate_pipeline.py:242-267."""
    extra = dict(factor_num=32, deep_net_num_layers=2, cross_net_num_layers=3,
                 num_ng=1, max_sample_items=5, emb_dropout=0.2, use_layer_norm=True)
    return TrainArgs(
        model_name="DCN", dataset_name="Q", seed=ns.downstream_seed,
        num_epochs=ns.downstream_epochs, train_batch_size=256, test_batch_size=512,
        lr=1e-3, decay=1e-3, early=4, early_criterion="auc", valid_size=0.2,
        mp_enabled=True, gradient_max_norm=5.0, ckpt_interval=1_000_000,
        log_dir=f"{ns.out}/logs", extra=with_export(extra, emb_path),
    )


# ----------------------------------------------------------------------
# stages
# ----------------------------------------------------------------------

def make_dataset(ns: argparse.Namespace):
    """(artifacts, signal): the published shape at its calibrated signal
    (or ``--signal``), else the synthetic dataset of the given size."""
    if ns.shape:
        signal = ns.signal if ns.signal is not None else CALIBRATED_SIGNAL[ns.shape]
        return make_published_shape_dataset(ns.shape, seed=DATA_SEED, signal=signal), signal
    return make_synthetic_dataset(
        num_nodes=ns.num_nodes, num_users=ns.num_users, num_clusters=40,
        feat_dims=(1536, 768), interactions_per_user=15, avg_degree=16, seed=DATA_SEED,
    ), None


def run_task(task_mod, args: TrainArgs, art, registry: RunRegistry, run_name: str,
             device: str, export_path: Optional[str] = None):
    """One stage through the task API: check, seed, data, model, a run
    named ``run_name``, train; then the test metrics, or with
    ``export_path`` the export written there. Returns (result, run)."""
    ctx: Dict[str, Any] = {"artifacts": art, "device": device}
    task_mod.check_args(args)
    task_mod.init_run(args)
    task_mod.init_dataloader(args, ctx)
    task_mod.init_model(args, ctx)
    run = registry.create_run(run_name, args.to_dict())
    res = task_mod.train(args, ctx, registry, run)
    if export_path is not None:
        args.inference_result_path = export_path
        task_mod.inference(args, ctx, registry, run)
        return res, run
    return task_mod.test(args, ctx, registry, run), run


def stage_pmgt(ns, art, registry, results) -> str:
    """PMGT pre-training, then the export; returns the export's path."""
    emb_path = f"{ns.out}/node_feat_128dim.npy"
    results["pmgt"], _ = run_task(pmgt_task, pmgt_args(ns), art, registry, "PMGT",
                                  ns.device, export_path=emb_path)
    print("PMGT:", results["pmgt"], flush=True)
    return emb_path


def stage_downstream(ns, art, registry, results, name: str, task: str, args: TrainArgs):
    """One downstream run (``task`` in ncf, pmgt_ncf, dcn) with ``args``;
    its test metrics go to ``results[name]``. Returns its run."""
    task_mod = importlib.import_module(f"pmgt_tpu_torch.tasks.{task}_task")
    results[name], run = run_task(task_mod, args, art, registry, name, ns.device)
    print(f"{name}:", results[name], flush=True)
    return run


def run(ns: argparse.Namespace, argv: Sequence[str] = ()) -> Dict[str, Any]:
    """Every stage ``ns`` asks for; writes and returns ``results.json``."""
    os.makedirs(ns.out, exist_ok=True)
    results: Dict[str, Any] = {"provenance": provenance(argv)}
    art, signal = make_dataset(ns)
    if signal is not None:
        results["signal"] = signal
    print(f"dataset: {art.num_nodes} nodes, {art.num_users} users, "
          f"{len(art.train_pairs)} train pairs", flush=True)
    registry = RunRegistry(f"{ns.out}/logs")
    if ns.emb_path:
        emb_path = ns.emb_path
        print(f"reusing PMGT embeddings from {emb_path} (pretrain skipped)", flush=True)
    else:
        emb_path = stage_pmgt(ns, art, registry, results)

    families = set(ns.families.split(","))

    def ncf(name, model_name, extra):
        return stage_downstream(ns, art, registry, results, name, "ncf",
                                ncf_args(ns, model_name, extra))

    if "neumf" in families:
        for tag, emb in (("plain", None), ("pmgt", emb_path)):
            ncf(f"ncf_{tag}", "NeuMF-end", with_export(BASE_NCF, emb))
    gmf_run = mlp_run = None
    if families & {"gmf", "neumf_pre"}:
        gmf_run = ncf("gmf", "GMF", BASE_NCF)
    if families & {"mlp", "neumf_pre"}:
        mlp_run = ncf("mlp", "MLP", BASE_NCF)
    if "neumf_pre" in families:
        stage_downstream(ns, art, registry, results, "neumf_pre", "ncf",
                         neumf_pre_args(ns, gmf_run.run_id, mlp_run.run_id))
    if "pmgt_ncf" in families:
        stage_downstream(ns, art, registry, results, "pmgt_ncf", "pmgt_ncf", pmgt_ncf_args(ns))
    if "dcn" in families:
        for tag, emb in (("plain", None), ("pmgt", emb_path)):
            stage_downstream(ns, art, registry, results, f"dcn_{tag}", "dcn", dcn_args(ns, emb))

    with open(f"{ns.out}/results.json", "w") as f:
        json.dump(results, f, indent=2)
    print("\nFINAL:", json.dumps(results, indent=2), flush=True)
    return results


def parse(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pmgt-epochs", type=int, default=8)
    ap.add_argument("--downstream-epochs", type=int, default=12)
    ap.add_argument("--out", default="outputs/quality")
    ap.add_argument("--no-ctx-cache", action="store_true",
                    help="PMGT stage with exact per-occurrence sampling")
    ap.add_argument("--families", default=FAMILIES,
                    help="comma list of downstream families to run "
                    "(neumf, dcn, gmf, mlp, neumf_pre, pmgt_ncf)")
    ap.add_argument("--num-nodes", type=int, default=6500)
    ap.add_argument("--num-users", type=int, default=5000)
    ap.add_argument("--shape", choices=["VG", "TG"], default=None,
                    help="the published scale and sparsity of VG or TG "
                    "(overrides --num-nodes/--num-users)")
    ap.add_argument("--signal", type=float, default=None,
                    help="graph-to-interaction signal of a --shape dataset "
                    "(default: CALIBRATED_SIGNAL of the shape)")
    ap.add_argument("--emb-path", default=None,
                    help="reuse an exported PMGT embedding .npy and skip pre-training")
    ap.add_argument("--downstream-seed", type=int, default=0,
                    help="seed of the downstream training runs")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    logging.basicConfig(level=logging.INFO)
    run(parse(argv), argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
