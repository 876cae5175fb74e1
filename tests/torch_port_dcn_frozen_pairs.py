"""The frozen ``real`` arm of the DCN sensitivity in both packages, paired
on one export, at TG, on the CPU: does the port's DCN part from the JAX
package's where both see the same data, the same export and the same
arithmetic (f32 on the CPU)?

    python tests/torch_port_dcn_frozen_pairs.py --emb E.npy --out DCN_FROZEN_PAIRS_TG_CPU.json

``E.npy`` is the port's seed-0 PMGT export of ``--evidence dcn-frozen``
(``chip_smoke.py --bisect dcn-frozen-bf16`` writes it again, to the bit,
as ``outputs/bisect_dcn-frozen-bf16_s0/node_feat_128dim.npy``); the record
names it by its sha256. The data is the TG shape at
``CALIBRATED_SIGNAL["TG"]`` and data seed 42 (``tools/dcn_sensitivity.py:
68-69``), built by each package and held bit-equal (a hash of every split
and label array in each job). Each job is one DCN run with ``run_dcn``'s
arguments (``tools/dcn_sensitivity.py:119-146``; the port's ``dcn_args``)
and ``--freeze``: the ``real`` arm at each seed of ``--seeds`` and the
``plain`` arm at seed 0 as an anchor, in each package. Every job is a
process of its own with ``THREADS`` CPU threads, all at once; a job whose
result is already in ``--work`` is not run again (``--job`` runs one by
hand). On an 8-core host the four JAX jobs take ~50 min and the port's
2-3 h: each port step makes AdamW passes over the whole 134,697-row user
table, which XLA fuses into one.

The record: each seed's test AUC in each package, means and sample σ, the
gap of the means (port − JAX) against the tool's own bound max(3σ_port,
0.005) (``pmgt_tpu_torch.tools.dcn_sensitivity.compare_to_jax``) and
against the combined standard error, the port's seed-0 AUC here beside
the card's record, JAX's mean here against its TPU record's, and each
job's seconds. The JAX runs need the JAX
package, so this is a script beside the tests (it imports both) rather
than part of the port.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import logging
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CARD_RECORD = "DCN_SENSITIVITY_TORCH_TG_FROZEN.json"
# CPU threads of a job: 4 JAX jobs at 1 and 4 port jobs at 2 fill 8 cores
# once the JAX jobs end; the port's step is ~1.6x faster at 2 than at 1
THREADS = {"jax": 1, "port": 2}
JAX_RECORD = "DCN_SENSITIVITY_TG_FROZEN.json"


def data_hash(art) -> str:
    """sha256 over the arrays a DCN run reads from the dataset."""
    import numpy as np

    h = hashlib.sha256()
    for name in ("train_pairs", "test_pairs", "item_classes", "node_classes"):
        a = getattr(art, name)
        h.update(b"none" if a is None else np.ascontiguousarray(a).tobytes())
    h.update(repr((art.num_users, art.num_items, art.num_nodes)).encode())
    return h.hexdigest()


def run_job(package: str, arm: str, seed: int, work: str) -> dict:
    """One DCN run in this process: ``arm`` (real or plain) at ``seed`` in
    ``package`` (port or jax)."""
    from pmgt_tpu_torch.tools import dcn_sensitivity as ds

    ns = ds.parse(["--shape", "TG", "--freeze", "--out", work, "--device", "cpu"])
    emb = os.path.join(work, "emb_real.npy") if arm == "real" else None
    name = f"dcn_{arm}_s{seed}"
    t0 = time.perf_counter()
    if package == "port":
        import torch

        from pmgt_tpu_torch.tasks import dcn_task
        from pmgt_tpu_torch.tools import validate_pipeline as vp
        from pmgt_tpu_torch.train.registry import RunRegistry

        art, signal = ds.make_dataset(ns)
        log_dir = os.path.join(work, f"port_{name}")
        res, _ = vp.run_task(dcn_task, ds.dcn_args(ns, seed, emb, log_dir), art,
                             RunRegistry(log_dir), name, "cpu")
        threads = torch.get_num_threads()
    else:
        import jax

        jax.config.update("jax_platforms", "cpu")
        sys.path.insert(0, os.path.join(REPO, "tests"))
        from torch_port_dcn_bisect import jax_args, jax_run

        from pmgt_tpu.data.synthetic import CALIBRATED_SIGNAL, make_published_shape_dataset
        from pmgt_tpu.tasks import dcn_task
        from pmgt_tpu.train.registry import RunRegistry

        signal = CALIBRATED_SIGNAL["TG"]
        art = make_published_shape_dataset("TG", seed=42, signal=signal)
        log_dir = os.path.join(work, f"jax_{name}")
        res = {"test/auc": jax_run(dcn_task, jax_args(ds.dcn_args(ns, seed, emb, log_dir)), art,
                                   RunRegistry(log_dir), name)}
        threads = None
    return {"package": package, "arm": arm, "seed": seed, "test_auc": res["test/auc"],
            "signal": signal, "data_sha256": data_hash(art), "torch_threads": threads,
            "seconds": time.perf_counter() - t0}


def mean_std(values) -> dict:
    from pmgt_tpu_torch.tools import validate_pipeline as vp

    return vp.mean_std(list(values))


def analyse(jobs: list, emb_sha: str, seeds) -> dict:
    """The record from the jobs' rows."""
    from pmgt_tpu_torch.tools import dcn_sensitivity as ds

    auc = {p: {str(j["seed"]): j["test_auc"] for j in jobs if j["package"] == p
               and j["arm"] == "real"} for p in ("port", "jax")}
    plain = {j["package"]: j["test_auc"] for j in jobs if j["arm"] == "plain"}
    port, ref = mean_std(auc["port"].values()), mean_std(auc["jax"].values())
    gap = port["mean"] - ref["mean"]
    se = math.sqrt(port["std"] ** 2 / port["n"] + ref["std"] ** 2 / ref["n"])
    bound = max(ds.SIGMAS * port["std"], ds.AUC_FLOOR)
    with open(os.path.join(REPO, CARD_RECORD)) as f:
        card = json.load(f)["auc_exact"]
    with open(os.path.join(REPO, JAX_RECORD)) as f:
        jax_rec = json.load(f)["auc"]
    hashes = {j["data_sha256"] for j in jobs}
    return {
        "what": "frozen real arm of the DCN sensitivity, both packages paired on one export "
                "at TG on the CPU in f32; plain arm at seed 0 as an anchor",
        "export_sha256": emb_sha, "seeds": list(seeds),
        "data_bit_equal_in_both_packages": len(hashes) == 1, "data_sha256": sorted(hashes),
        "real_frozen_test_auc": auc, "plain_test_auc_s0": plain,
        "port": port, "jax": ref, "gap_port_minus_jax": gap, "combined_se": se,
        "gap_over_se": gap / se if se else None,
        "bound": bound, "bound_rule": "max(3 * port sample sigma, 0.005), the tool's own",
        "within_bound": abs(gap) <= bound,
        "port_s0_cpu_vs_card": {"cpu": auc["port"].get("0"), "card": card["real_s0"],
                                "cpu_minus_card": auc["port"]["0"] - card["real_s0"]
                                if "0" in auc["port"] else None},
        "jax_record_on_tpu_v5e": {k: v for k, v in jax_rec.items()
                                  if k.startswith(("real_", "plain_"))},
        "jax_cpu_minus_its_tpu_record": ref["mean"] - mean_std(
            v for k, v in jax_rec.items() if k.startswith("real_"))["mean"],
        "jobs": jobs,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--emb", required=True, help="the export E (.npy, [nodes, 128])")
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--out", default="DCN_FROZEN_PAIRS_TG_CPU.json")
    ap.add_argument("--work", default=None, help="scratch directory (default: a new temp dir)")
    ap.add_argument("--job", default=None, help="internal: package:arm:seed, run in this process")
    cli = ap.parse_args(argv)
    if cli.job:
        import torch

        logging.basicConfig(level=logging.INFO)
        package, arm, seed = cli.job.split(":")
        torch.set_num_threads(THREADS[package])
        row = dict(run_job(package, arm, int(seed), cli.work), threads=THREADS[package])
        with open(os.path.join(cli.work, f"{cli.job.replace(':', '_')}.json"), "w") as f:
            json.dump(row, f)
        return 0

    import numpy as np

    from pmgt_tpu_torch.tools import dcn_sensitivity as ds

    work = cli.work or tempfile.mkdtemp(prefix="dcn_frozen_pairs_")
    os.makedirs(work, exist_ok=True)
    with open(cli.emb, "rb") as f:
        emb_sha = hashlib.sha256(f.read()).hexdigest()
    np.save(os.path.join(work, "emb_real.npy"), ds.variants(np.load(cli.emb))["real"])
    seeds = [int(s) for s in cli.seeds.split(",")]
    jobs = [f"{p}:real:{s}" for s in seeds for p in ("port", "jax")]
    jobs += [f"{p}:plain:0" for p in ("port", "jax")]
    procs = []
    try:
        for job in jobs:
            if os.path.exists(os.path.join(work, f"{job.replace(':', '_')}.json")):
                print("reusing", job, flush=True)  # a job of an earlier call in --work
                continue
            n = str(THREADS[job.split(":")[0]])
            env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS=n, MKL_NUM_THREADS=n,
                       XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                       "intra_op_parallelism_threads=" + n)
            log = open(os.path.join(work, f"{job.replace(':', '_')}.log"), "w")
            procs.append((job, log, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--emb", cli.emb, "--work", work,
                 "--job", job], cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)))
            print("started", job, flush=True)
        for job, log, p in procs:
            if p.wait() != 0:
                raise RuntimeError(f"{job} failed: see {log.name}")
            print("done", job, flush=True)
    finally:
        for _, log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    rows = []
    for job in jobs:
        with open(os.path.join(work, f"{job.replace(':', '_')}.json")) as f:
            rows.append(json.load(f))
    record = dict(analyse(rows, emb_sha, seeds), threads_per_job=THREADS)
    with open(cli.out, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({k: v for k, v in record.items() if k != "jobs"}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
