"""The readings the limits of ``correct`` are set from, for one cell, over
many seeds in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 [--seconds 3]
        [--control] [--faults half_batch]

For each seed: the cell's set-up, a short window and the driver's
``tail``, then the numbers its check compares (the program's readings), and with
``--control`` the same numbers of the plain reference computed in the
configuration's ``control_precision`` and put in the program's place;
``--faults`` plants each named fault in the reference instead. One JSON
line per seed on standard output. The benchmark's own runs never run
this.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import run as bench_run
    from benchmark.harness import spec

    bench_run.environment()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    cell = spec.find_cell(spec.load_benchmark(ROOT), args.workload, ROOT)
    driver = spec.load_driver(cell.traffic["driver"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        state = driver.setup(bench_run.Run(cell, seed, device))
        setup_s = time.perf_counter() - t0
        window = driver.window(state, args.seconds)["metrics"]
        driver.tail(state)
        driver.release(state)
        gc.collect()
        torch.cuda.empty_cache()
        row = {"seed": seed, "setup_s": setup_s, "window": window,
               "program": {c["name"]: c["value"] for c in driver.check(state)}}
        row["program"].update(state.get("readings", {}))
        if args.control:
            row["control"] = driver.control(state, cell.config["control_precision"], device)
        for fault in filter(None, args.faults.split(",")):
            row[fault] = driver.control(state, "f32", device, fault=fault)
        print(json.dumps(row), flush=True)
        del state
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
