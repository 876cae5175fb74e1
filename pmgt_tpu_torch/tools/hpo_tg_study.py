"""The conditional MLP-PMGT search at the TG shape on real trials
(counterpart of ``tools/hpo_tg_study.py``).

    python -m pmgt_tpu_torch.tools.hpo_tg_study [--work DIR] [--n-trials 5]

The space is ``config/hpo/hpo_ncf_mlp_pmgt_params.yaml``: a
``factor_num`` × ``num_layers`` grid whose arms either prune the trial or
couple ``item_init_emb_path`` to the PMGT export whose width is the MLP's
input width (``ARM_DIM``), and a ``gmf_run_id`` choice in the
``factor_num`` 32 arm. Its placeholders are replaced by exports and a run
this tool builds first. Stages, each a subprocess of the port's CLI
(``python -m pmgt_tpu_torch.cli.main --device <dev>``):

1. ``make-synthetic --shape TG`` at the calibrated signal (skipped when
   ``<work>/data/TG/meta.json`` exists);
2. PMGT pre-training and export at hidden 32, 64 and 128 (skipped for a
   width whose export exists);
3. one GMF run, for the ``gmf_run_id`` arm (stages 2 and 3 side by side);
4. the substituted space, written as JSON (the card has no PyYAML;
   ``hp-tuning`` reads ``.json`` spaces), then ``hp-tuning --train-name ncf
   --enable-trial-pruning``, extended a trial at a time (at most four
   rounds) until the study holds ``MIN_COMPLETE`` COMPLETE and
   ``MIN_PRUNED`` PRUNED trials;
5. the best trial restored with ``--mode eval`` (the test split, as the
   JAX tool), and its best checkpoint evaluated again in this process as
   its trial evaluated it, which must give the trial's logged results.

The signal defaults to ``CALIBRATED_SIGNAL["TG"]`` (0.5), the value of the
JAX record. The JAX tool looks it up by matching a literal in
``tools/validate_pipeline.py``, which no longer defines it, and falls back
to 1.0. Each stage's K1–K4 launches come from its subprocess's last log
line; each trial's from the study's trials JSON (``cli_runner``).
"""
from __future__ import annotations

import argparse
import copy
import json
import logging
import os
import re
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from pmgt_tpu_torch.cli import space_yaml
from pmgt_tpu_torch.data.synthetic import CALIBRATED_SIGNAL
from pmgt_tpu_torch.tools import cli_runner as cr
from pmgt_tpu_torch.tools import validate_pipeline as vp
from pmgt_tpu_torch.train.registry import RunRegistry

REPO = vp.REPO

# (factor_num, num_layers) -> export width of every non-pruned arm (the MLP's
# input width factor_num * 2**(num_layers - 1)); tools/hpo_tg_study.py:38-42
ARM_DIM = {
    (8, 3): 32, (8, 4): 64, (8, 5): 128,
    (16, 2): 32, (16, 3): 64, (16, 4): 128,
    (32, 2): 64, (32, 3): 128,
}
MIN_COMPLETE = 4
MIN_PRUNED = 1
EXPERIMENT = "MLP-PMGT-HPO-TG"
STUDY = "mlp_pmgt_tg"

# the comparison with the JAX package's record (bounds fixed up front)
BEST_SLACK = 0.01  # the best trial's value >= JAX's best - this


# ----------------------------------------------------------------------
# the stages (tools/hpo_tg_study.py)
# ----------------------------------------------------------------------

def pretrain_args(data_dir: str, log_dir: str, hidden: int, epochs: int) -> List[Any]:
    """tools/hpo_tg_study.py:66-77: PMGT pre-training at ``hidden``."""
    return ["train-pmgt", "--model-name", "PMGT", "--dataset-name", "TG",
            "--data-dir", data_dir, "--log-dir", log_dir,
            "--num-epochs", epochs, "--train-batch-size", 256,
            "--test-batch-size", 512, "--lr", 1e-4, "--decay", 1e-2,
            "--early", 5, "--early-criterion", "auc", "--mp-enabled",
            "--gradient-max-norm", 5.0, "--ckpt-interval", 1000000,
            "--hidden-size", hidden, "--intermediate-size", hidden,
            "--num-hidden-layers", 5, "--experiment-name", f"PMGT-h{hidden}"]


def export_args(data_dir: str, log_dir: str, hidden: int, run_id: str, emb: str) -> List[Any]:
    """tools/hpo_tg_study.py:82-90: the export of the pre-training run."""
    return ["train-pmgt", "--model-name", "PMGT", "--dataset-name", "TG",
            "--data-dir", data_dir, "--log-dir", log_dir,
            "--hidden-size", hidden, "--intermediate-size", hidden,
            "--num-hidden-layers", 5, "--mp-enabled",
            "--lr", 1e-4, "--decay", 1e-2, "--gradient-max-norm", 5.0,
            "--mode", "inference", "--run-id", run_id, "--inference-result-path", emb]


def gmf_args(data_dir: str, log_dir: str) -> List[Any]:
    """tools/hpo_tg_study.py:179-188: the GMF run of the gmf_run_id arm."""
    return ["train-ncf", "--model-name", "GMF", "--dataset-name", "TG",
            "--data-dir", data_dir, "--log-dir", log_dir,
            "--num-epochs", 8, "--train-batch-size", 256,
            "--test-batch-size", 512, "--lr", 1e-3, "--decay", 0.0,
            "--early", 4, "--early-criterion", "n20", "--mp-enabled",
            "--gradient-max-norm", 5.0, "--factor-num", 32,
            "--num-ng", 1, "--max-sample-items", 500, "--valid-size", 0.2,
            "--experiment-name", "GMF-for-HPO"]


def train_params(data_dir: str, log_dir: str, trial_epochs: int, emb32: str) -> Dict[str, Any]:
    """tools/hpo_tg_study.py:200-210: config/hpo/train_ncf_mlp_pmgt_params.json
    on the TG data with the trial budget."""
    with open(os.path.join(REPO, "config/hpo/train_ncf_mlp_pmgt_params.json"),
              encoding="utf-8") as f:
        params = json.load(f)
    params.update(dataset_name="TG", data_dir=data_dir, log_dir=log_dir,
                  num_epochs=trial_epochs, early=4, valid_size=0.2,
                  experiment_name=EXPERIMENT, item_init_emb_path=emb32, max_sample_items=500)
    return params


def substitute_space(emb_paths: Dict[int, str], gmf_run_id: str) -> Dict[str, Any]:
    """tools/hpo_tg_study.py:94-126: the space with every ``*<d>dim.npy``
    static replaced by the export of width d, and the run-id choice by
    ``gmf_run_id``."""
    with open(os.path.join(REPO, "config/hpo/hpo_ncf_mlp_pmgt_params.yaml"),
              encoding="utf-8") as f:
        space = space_yaml.load(f.read())

    def walk(node):
        if isinstance(node, dict):
            if node.get("type") == "static" and isinstance(node.get("value"), str):
                m = re.search(r"(\d+)dim\.npy$", node["value"])
                if m:
                    node["value"] = emb_paths[int(m.group(1))]
            for k, v in node.items():
                if k == "value" and isinstance(v, list):
                    node[k] = [gmf_run_id if isinstance(x, str)
                               and re.fullmatch(r"[0-9a-f]{32}", x) else x for x in v]
                else:
                    walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(space)
    return space


def restore_args(best: Dict[str, Any], run_id: str, data_dir: str, log_dir: str,
                 emb_paths: Dict[int, str]) -> List[Any]:
    """tools/hpo_tg_study.py:265-280: the best trial in ``--mode eval``."""
    p = best["params"]
    fn, nl = int(p["factor_num"]), int(p["num_layers"])
    return ["train-ncf", "--mode", "eval", "--run-id", run_id,
            "--model-name", "MLP", "--dataset-name", "TG",
            "--data-dir", data_dir, "--log-dir", log_dir,
            "--factor-num", fn, "--num-layers", nl,
            "--item-init-emb-path", emb_paths[ARM_DIM[(fn, nl)]],
            "--normalize-item-init-emb", "--mp-enabled",
            "--num-ng", 1, "--max-sample-items", 500, "--valid-size", 0.2,
            "--seed", int(p["seed"]),
            "--dropout", p["dropout"], "--emb-dropout", p["emb_dropout"],
            "--train-batch-size", int(p["train_batch_size"]),
            "--test-batch-size", 512]


def make_dataset(ns: argparse.Namespace, tg_dir: str) -> Dict[str, Any]:
    """Stage 1 (tools/hpo_tg_study.py:155-161)."""
    return cr.make_tg_dataset(tg_dir, ns.signal, ns.device)


def run(ns: argparse.Namespace, rounds: int = cr.ROUNDS) -> Dict[str, Any]:
    """Every stage; writes ``--out`` and returns the report: the JAX
    tool's keys (``work``, ``signal``, ``stages``, ``trials``,
    ``n_complete``, ``n_pruned``, ``best``, ``best_restore_eval``,
    ``best_run_id``), then ``provenance``, each trained trial's logged
    record (``trial_records``), the in-process restore and the checks
    ``compare_to_jax`` needs. ``rounds`` bounds the hp-tuning invocations."""
    t0 = time.perf_counter()
    work = os.path.abspath(ns.work)
    data_dir, log_dir = os.path.join(work, "data"), os.path.join(work, "logs")
    tg_dir = os.path.join(data_dir, "TG")
    os.makedirs(work, exist_ok=True)
    report: Dict[str, Any] = {"work": work, "signal": ns.signal,
                              "stages": [make_dataset(ns, tg_dir)]}
    num_nodes = cr.num_nodes_of(tg_dir)
    emb_paths = {h: os.path.join(tg_dir, f"node_feat_{h}dim.npy") for h in (32, 64, 128)}

    def pretrain(hidden):
        """Stage 2 at ``hidden``: pre-training, then its export."""
        t = time.perf_counter()
        emb = emb_paths[hidden]
        out = cr.run_cli(pretrain_args(data_dir, log_dir, hidden, ns.pretrain_epochs),
                         ns.device)
        rid = cr.last_run_id(out)
        train_launches = cr.launches_of(out)
        export_launches = cr.launches_of(
            cr.run_cli(export_args(data_dir, log_dir, hidden, rid, emb), ns.device))
        epochs = cr.evaluations(RunRegistry(log_dir).get_run(rid))
        return {
            "stage": f"pretrain_h{hidden}", "run_id": rid, "emb": emb,
            "seconds": time.perf_counter() - t, "epochs": epochs,
            "launches": {"train": train_launches, "export": export_launches},
            "expected_launches": {
                "train": cr.expected(ns.device, cr.pmgt_run_launches(num_nodes, 0.2, 256, 512,
                                                                     5, epochs)),
                "export": cr.expected(ns.device, cr.pmgt_run_launches(
                    num_nodes, 0.2, 256, 256, 5, 0, tests=0, export_batch=256))}}

    def gmf():
        """Stage 3."""
        out = cr.run_cli(gmf_args(data_dir, log_dir), ns.device)
        return {"stage": "gmf", "run_id": cr.last_run_id(out), "launches": cr.launches_of(out)}

    # Stages 2 and 3 do not depend on one another: each chain of processes
    # runs beside the others (host bound, the card mostly idle).
    with ThreadPoolExecutor(4) as pool:
        jobs = [pool.submit(pretrain, h) for h, e in emb_paths.items() if not os.path.exists(e)]
        jobs.append(pool.submit(gmf))
        report["stages"] += [j.result() for j in jobs]
    gmf_rid = report["stages"][-1]["run_id"]

    space_path = os.path.join(work, "hpo_ncf_mlp_pmgt_params.TG.json")
    with open(space_path, "w", encoding="utf-8") as f:
        json.dump(substitute_space(emb_paths, gmf_rid), f, indent=2)
    params_path = os.path.join(work, "train_ncf_mlp_pmgt_params.TG.json")
    with open(params_path, "w", encoding="utf-8") as f:
        json.dump(train_params(data_dir, log_dir, ns.trial_epochs, emb_paths[32]), f, indent=2)

    storage = os.path.join(work, "hpo_storage.db")
    done = cr.study(["--hp-config-path", space_path, "--train-config-path", params_path,
                  "--study-name", STUDY, "--storage-path", storage, "--train-name", "ncf",
                  "--enable-trial-pruning"], ns.n_trials,
                 os.path.join(work, f"{STUDY}_trials.json"),
                 lambda c, p: c >= MIN_COMPLETE and p >= MIN_PRUNED, ns.device, rounds)
    trials = done["trials"]
    report.update(trials=trials, n_complete=done["n_complete"], n_pruned=done["n_pruned"])
    best = max((t for t in trials if t["state"] == "COMPLETE"), key=lambda t: t["value"])
    report["best"] = copy.deepcopy(best)

    best_run = cr.tagged_run(log_dir, EXPERIMENT, best["number"])
    out = cr.run_cli(restore_args(best, best_run.run_id, data_dir, log_dir, emb_paths),
                     ns.device)
    report["best_restore_eval"] = cr.test_results(out)
    report["best_run_id"] = best_run.run_id

    report["provenance"] = vp.provenance(ns.argv)
    report["trial_records"] = {}
    for t in trials:
        if t["state"] != "COMPLETE":
            continue
        run_ = cr.tagged_run(log_dir, EXPERIMENT, t["number"])
        emb = run_.params["item_init_emb_path"]
        report["trial_records"][str(t["number"])] = {
            **done["records"][t["number"]], "epochs": cr.evaluations(run_),
            "emb_dim": int(np.load(emb, mmap_mode="r").shape[1])}
    report["invocation_s"] = done["invocation_s"]
    report["restore_in_process"] = cr.restore_in_process("ncf", best_run, ns.device)
    report["seconds"] = time.perf_counter() - t0
    with open(ns.out, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=2)
    print(json.dumps({"n_complete": report["n_complete"], "n_pruned": report["n_pruned"],
                      "best_value": best["value"], "best_params": best["params"],
                      "restore_eval": report["best_restore_eval"]}, indent=2), flush=True)
    return report


def compare_to_jax(report: Dict[str, Any], jax: Dict[str, Any]) -> Dict[str, Any]:
    """Hold a report against ``HPO_TG_MLP_PMGT.json``:

    - at least ``MIN_COMPLETE`` COMPLETE and ``MIN_PRUNED`` PRUNED trials;
    - every PRUNED trial in a ``prune: true`` arm (its factor_num,
      num_layers not in ``ARM_DIM``), every COMPLETE trial on the export
      of the width ``ARM_DIM`` names;
    - the best value at least JAX's best − 0.01;
    - the best checkpoint, restored in this process, equal to its trial's
      logged results within 1e-5 (the CLI restore reads the test split and
      is recorded beside JAX's);
    - each PMGT stage's K1–K4 launches exactly as the code predicts.

    Returns the rows, ``ok`` and the missed checks."""
    trials = report["trials"]
    arm = lambda t: (int(t["params"]["factor_num"]), int(t["params"]["num_layers"]))  # noqa: E731
    pruned = [t for t in trials if t["state"] == "PRUNED"]
    complete = [t for t in trials if t["state"] == "COMPLETE"]
    recs = report["trial_records"]
    best_logged = recs[str(report["best"]["number"])]["results"]
    rows = [
        {"check": f"COMPLETE trials >= {MIN_COMPLETE}", "port": len(complete),
         "ok": len(complete) >= MIN_COMPLETE},
        {"check": f"PRUNED trials >= {MIN_PRUNED}", "port": len(pruned),
         "ok": len(pruned) >= MIN_PRUNED},
        {"check": "every PRUNED trial in a prune arm", "port": [arm(t) for t in pruned],
         "ok": all(arm(t) not in ARM_DIM for t in pruned)},
        {"check": "every COMPLETE trial on ARM_DIM's export",
         "port": {str(t["number"]): [list(arm(t)), recs[str(t["number"])]["emb_dim"]]
                  for t in complete},
         "ok": all(ARM_DIM.get(arm(t)) == recs[str(t["number"])]["emb_dim"] for t in complete)},
        {"check": "best value >= JAX best - 0.01", "port": report["best"]["value"],
         "floor": jax["best"]["value"] - BEST_SLACK,
         "ok": report["best"]["value"] >= jax["best"]["value"] - BEST_SLACK},
        cr.restore_check(best_logged, report["restore_in_process"]["results"]),
    ]
    stages = [s for s in report["stages"] if s["stage"].startswith("pretrain_h")]
    rows.append({"check": "PMGT stages' launches exact",
                 "port": {s["stage"]: s["launches"] for s in stages},
                 "ok": all(s["launches"] == s["expected_launches"] for s in stages)})
    return {"rows": rows, "ok": all(r["ok"] for r in rows),
            "misses": [r["check"] for r in rows if not r["ok"]]}


def parse(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", default="outputs/hpo_tg")
    ap.add_argument("--n-trials", type=int, default=5)
    ap.add_argument("--signal", type=float, default=CALIBRATED_SIGNAL["TG"],
                    help="default: the calibrated TG value")
    ap.add_argument("--pretrain-epochs", type=int, default=8)
    ap.add_argument("--trial-epochs", type=int, default=12)
    ap.add_argument("--out", default="outputs/HPO_TORCH_TG_MLP_PMGT.json")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ns = ap.parse_args(argv)
    ns.argv = list(argv or [])
    return ns


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    logging.basicConfig(level=logging.INFO)
    run(parse(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
