"""The PMGT pre-training search at the TG shape on real trials
(counterpart of ``tools/hpo_pmgt_study.py``).

    python -m pmgt_tpu_torch.tools.hpo_pmgt_study [--work DIR] [--n-trials 4]

The space is ``config/hpo/hpo_pmgt_params.yaml`` as published: lr, β
from 0 to 1 in steps of 0.25, hidden 32/64/128 with the intermediate size
each arm pins, the layer count and the mask ratio. A trial is a whole PMGT
pre-training on K1/K2. Stages, each a subprocess of the port's CLI:

1. ``make-synthetic --shape TG`` at the calibrated signal (skipped when
   ``<work>/data/TG/meta.json`` exists);
2. ``hp-tuning --train-name pmgt --enable-trial-pruning`` with 6-epoch
   trials, extended a trial at a time (at most four rounds) until the
   study holds ``MIN_COMPLETE`` COMPLETE and ``MIN_PRUNED`` PRUNED trials;
3. the best trial restored with ``--mode eval`` (the test phase's draw,
   as the JAX tool), and its best checkpoint evaluated again in this
   process as its trial evaluated it, which must give the trial's logged
   results.

Without Optuna (the card machine has none) ``hp-tuning`` runs its
built-in study, whose ``should_prune`` is always False, and this space has
no ``prune: true`` arm: no trial is pruned, so every run takes the four
rounds, as the JAX record's seven trials did.
"""
from __future__ import annotations

import argparse
import copy
import json
import logging
import os
import sys
import time
from typing import Any, Dict, List, Optional, Sequence

from pmgt_tpu_torch.data.synthetic import CALIBRATED_SIGNAL
from pmgt_tpu_torch.tools import cli_runner as cr
from pmgt_tpu_torch.tools import validate_pipeline as vp

REPO = vp.REPO
MIN_COMPLETE = 3
MIN_PRUNED = 1
EXPERIMENT = "PMGT-HPO-TG"
STUDY = "pmgt_tg"

# the comparison with the JAX package's record (bounds fixed up front)
BEST_SLACK = 0.01  # the best trial's value >= JAX's best - this


def train_params(data_dir: str, log_dir: str, trial_epochs: int) -> Dict[str, Any]:
    """tools/hpo_pmgt_study.py:80-88: config/hpo/train_pmgt_params.json on
    the TG data with the trial budget."""
    with open(os.path.join(REPO, "config/hpo/train_pmgt_params.json"), encoding="utf-8") as f:
        params = json.load(f)
    params.update(dataset_name="TG", data_dir=data_dir, log_dir=log_dir,
                  num_epochs=trial_epochs, early=3, train_batch_size=256,
                  test_batch_size=512, experiment_name=EXPERIMENT)
    return params


def make_dataset(ns: argparse.Namespace, tg_dir: str) -> Dict[str, Any]:
    """Stage 1 (tools/hpo_pmgt_study.py:73-77)."""
    return cr.make_tg_dataset(tg_dir, ns.signal, ns.device)


def restore_args(best: Dict[str, Any], run_id: str, data_dir: str, log_dir: str,
                 params: Dict[str, Any]) -> List[Any]:
    """tools/hpo_pmgt_study.py:159-172: the best trial in ``--mode eval``."""
    p = best["params"]
    hidden = int(p["hidden_size"])
    return ["train-pmgt", "--mode", "eval", "--run-id", run_id,
            "--model-name", "PMGT", "--dataset-name", "TG",
            "--data-dir", data_dir, "--log-dir", log_dir,
            "--hidden-size", hidden, "--intermediate-size", hidden,
            "--num-hidden-layers", int(p["num_hidden_layers"]),
            "--beta", p["beta"], "--mask-node-ratio", p["mask_node_ratio"],
            "--lr", p["lr"], "--decay", params["decay"],
            "--gradient-max-norm", params["gradient_max_norm"],
            "--mp-enabled", "--valid-size", params["valid_size"],
            "--early-criterion", "auc",
            "--train-batch-size", 256, "--test-batch-size", 512,
            "--seed", int(p.get("seed", params["seed"]))]


def trial_launches(num_nodes: int, run_params: Dict[str, Any], epochs: int,
                   device: str) -> Dict[str, int]:
    """K1–K4 a PMGT trial launches: its epochs' steps and evaluations and
    the test of its best checkpoint (the validation split under
    hp-tuning)."""
    p = run_params
    return cr.expected(device, cr.pmgt_run_launches(
        num_nodes, p["valid_size"], p["train_batch_size"], p["test_batch_size"],
        int(p["num_hidden_layers"]), epochs, seed=int(p["seed"])))


def run(ns: argparse.Namespace, rounds: int = cr.ROUNDS) -> Dict[str, Any]:
    """Every stage; writes ``--out`` and returns the report: the JAX
    tool's keys, then ``provenance``, each trial's logged record with its
    epochs, parameters and expected launches (``trial_records``), and the
    in-process restore. With no COMPLETE trial the report is partial, as
    the JAX tool's (tools/hpo_pmgt_study.py:128-138). ``rounds`` bounds
    the hp-tuning invocations."""
    t0 = time.perf_counter()
    work = os.path.abspath(ns.work)
    data_dir, log_dir = os.path.join(work, "data"), os.path.join(work, "logs")
    tg_dir = os.path.join(data_dir, "TG")
    os.makedirs(work, exist_ok=True)
    report: Dict[str, Any] = {"work": work, "signal": ns.signal,
                              "stages": [make_dataset(ns, tg_dir)]}
    num_nodes = cr.num_nodes_of(tg_dir)

    params = train_params(data_dir, log_dir, ns.trial_epochs)
    params_path = os.path.join(work, "train_pmgt_params.TG.json")
    with open(params_path, "w", encoding="utf-8") as f:
        json.dump(params, f, indent=2)
    done = cr.study(["--hp-config-path", os.path.join(REPO, "config/hpo/hpo_pmgt_params.yaml"),
                     "--train-config-path", params_path, "--study-name", STUDY,
                     "--storage-path", os.path.join(work, "hpo_storage.db"),
                     "--train-name", "pmgt", "--enable-trial-pruning"], ns.n_trials,
                    os.path.join(work, f"{STUDY}_trials.json"),
                    lambda c, p: c >= MIN_COMPLETE and p >= MIN_PRUNED, ns.device, rounds)
    trials = done["trials"]
    report.update(trials=trials, n_complete=done["n_complete"], n_pruned=done["n_pruned"])
    report["provenance"] = vp.provenance(ns.argv)
    report["invocation_s"] = done["invocation_s"]
    report["trial_records"] = {}
    for t in trials:
        if t["state"] != "COMPLETE":
            continue
        run_ = cr.tagged_run(log_dir, EXPERIMENT, t["number"])
        epochs = cr.evaluations(run_)
        report["trial_records"][str(t["number"])] = {
            **done["records"][t["number"]], "epochs": epochs,
            "hidden_size": run_.params["hidden_size"], "beta": run_.params["beta"],
            "num_hidden_layers": run_.params["num_hidden_layers"],
            "expected_launches": trial_launches(num_nodes, run_.params, epochs, ns.device)}
    complete = [t for t in trials if t["state"] == "COMPLETE"]
    if not complete:
        report.update(best=None, error="no COMPLETE trials (all pruned/capped)")
    else:
        best = max(complete, key=lambda t: t["value"])
        report["best"] = copy.deepcopy(best)
        best_run = cr.tagged_run(log_dir, EXPERIMENT, best["number"])
        out = cr.run_cli(restore_args(best, best_run.run_id, data_dir, log_dir, params),
                         ns.device)
        report["best_restore_eval"] = cr.test_results(out)
        report["best_run_id"] = best_run.run_id
        report["restore_in_process"] = cr.restore_in_process("pmgt", best_run, ns.device)
        report["restore_expected_launches"] = cr.expected(ns.device, cr.pmgt_run_launches(
            num_nodes, params["valid_size"], 256, params["test_batch_size"],
            int(best_run.params["num_hidden_layers"]), 0, seed=int(best_run.params["seed"])))
    report["seconds"] = time.perf_counter() - t0
    with open(ns.out, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=2)
    print(json.dumps({"n_complete": report["n_complete"], "n_pruned": report["n_pruned"],
                      "best": report["best"],
                      "restore_eval": report.get("best_restore_eval")}, indent=2), flush=True)
    return report


def compare_to_jax(report: Dict[str, Any], jax: Dict[str, Any]) -> Dict[str, Any]:
    """Hold a report against ``HPO_TG_PMGT.json``:

    - at least ``MIN_COMPLETE`` COMPLETE trials (PRUNED is expected to be
      0, as in JAX's record: no ``prune: true`` arm, and the built-in
      study never prunes on metrics; the count is recorded, not bounded);
    - the best value at least JAX's best − 0.01;
    - the best checkpoint, restored in this process, equal to its trial's
      logged results within 1e-5;
    - each trial's K1–K4 launches, and the restore's, exactly as the code
      predicts.

    Returns the rows, ``ok`` and the missed checks."""
    recs = report["trial_records"]
    best = report.get("best")
    rows = [{"check": f"COMPLETE trials >= {MIN_COMPLETE}", "port": report["n_complete"],
             "pruned": report["n_pruned"], "ok": report["n_complete"] >= MIN_COMPLETE}]
    if best is not None:
        rows.append({"check": "best value >= JAX best - 0.01", "port": best["value"],
                     "floor": jax["best"]["value"] - BEST_SLACK,
                     "ok": best["value"] >= jax["best"]["value"] - BEST_SLACK})
        rows.append(cr.restore_check(recs[str(best["number"])]["results"],
                                     report["restore_in_process"]["results"]))
        rows.append({"check": "restore launches exact",
                     "port": report["restore_in_process"]["launches"],
                     "ok": report["restore_in_process"]["launches"]
                     == report["restore_expected_launches"]})
    rows.append({"check": "every trial's launches exact",
                 "port": {k: [r["launches"], r["expected_launches"]] for k, r in recs.items()},
                 "ok": bool(recs) and all(r["launches"] == r["expected_launches"]
                                          for r in recs.values())})
    return {"rows": rows, "ok": all(r["ok"] for r in rows),
            "misses": [r["check"] for r in rows if not r["ok"]]}


def parse(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", default="outputs/hpo_pmgt")
    ap.add_argument("--n-trials", type=int, default=4)
    ap.add_argument("--signal", type=float, default=CALIBRATED_SIGNAL["TG"])
    ap.add_argument("--trial-epochs", type=int, default=6)
    ap.add_argument("--out", default="outputs/HPO_TORCH_TG_PMGT.json")
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
