"""The benchmark of the PyTorch/CUDA port, one cell a run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's cards. Set-up
(data and weights from the seed, the program's task, warm-up of every
shape the cell uses) is timed as ``setup_s``; then, with ``--trace 0``, a
window of ``--seconds`` gives the cell's end-to-end metrics, or, with
``--trace 1``, a profiled sub-window its per-layer metrics. An end-to-end
metric whose source is the device trace is read, by its reader in
``metrics/``, from the window run under the profiler (the card's activity
alone). After the window the driver's ``tail`` runs what the check needs
past the window through the same calls (a training cell's next step), the
program's state is freed and the plain reference judges what the timed
path produced (``correct``). The last line of standard output
is the result as JSON; the numbers compared, each beside its limit, are
the last lines of standard error and the result's last key.

Exit codes: 0 a result; 2 bad arguments; 3 no card, or fewer than the
cell asks for; 4 a module of JAX or of the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pmgt_tpu")
CACHE_DIR = os.path.join(ROOT, "build", "bench_cache")
# Host threads of the run's own CPU work: the window is one Python thread
# issuing to the card, and idle worker threads only contend with it.
HOST_THREADS = 2


class Run:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device


def environment() -> None:
    """Kernel caches at fixed paths inside the checkout; libraries kept
    from loading JAX."""
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE_DIR, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE_DIR, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["USE_TF"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(HOST_THREADS)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's (the name compared whole)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def timed_window(cell, driver, state, seconds: float, device) -> dict:
    """The driver's window. Where an end-to-end metric of the cell comes
    from the device trace, the window runs under the profiler, recording
    the card's activity alone (``harness/trace.py``'s ``DeviceTrace``),
    and each such metric is read from that trace by its reader over all
    the window's units."""
    from benchmark.harness import common, spec
    from benchmark.harness.trace import DeviceTrace

    names = [m["name"] for m in cell.end_to_end if m["source"] == "device_trace"]
    if not names:
        return driver.window(state, seconds)
    if device.type != "cuda":
        raise RuntimeError(f"{names}: read from the card's trace, and there is no card")
    res: dict = {}

    def run(tick):
        res.update(driver.window(state, seconds, tick=tick))
        return res["attempted"]

    tr = DeviceTrace(lambda: common.sync(device)).run(run)
    print(f"device trace of the window: {len(tr.device)} device operations, {tr.units} units",
          file=sys.stderr)
    for name in names:
        value = spec.load_metric_reader(name).read(tr)
        if value is None:
            raise RuntimeError(f"{name}: the window's device trace holds nothing to read")
        res["metrics"][name] = value
    return res


def measure(cell, run, driver, state, args) -> dict:
    """The window's result: end-to-end metrics, or the traced per-layer
    metrics with the device's busy time and the breakdown."""
    from benchmark.harness import spec
    from benchmark.harness.trace import traced

    out: dict = {}
    if args.trace:
        tr = traced(driver.traced(state, cell.traffic), run.device.type == "cuda")
        out["metrics"] = spec.read_per_layer(cell, tr)
        out["attempted"], out["failed"] = tr.units, 0
        out["busy_s"], out["window_s"] = tr.busy_s(), tr.window_s
        out["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    else:
        res = timed_window(cell, driver, state, args.seconds, run.device)
        wanted = {m["name"]: m["unit"] for m in cell.end_to_end}
        out["metrics"] = {n: {"value": v, "unit": wanted[n]} for n, v in res["metrics"].items()
                          if n in wanted}
        out["attempted"], out["failed"] = res["attempted"], res["failed"]
    return out


def main(argv=None) -> int:
    args = parse(argv)
    environment()
    import torch

    from benchmark.harness import common, spec

    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False", file=sys.stderr)
        return 3
    cell = spec.find_cell(spec.load_benchmark(ROOT), args.workload, ROOT)
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, {torch.cuda.device_count()} visible",
              file=sys.stderr)
        return 3
    torch.set_num_threads(HOST_THREADS)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    driver = spec.load_driver(cell.traffic["driver"])
    run = Run(cell, args.seed, device)
    state = driver.setup(run)
    common.sync(device)
    setup_s = time.perf_counter() - T_START
    gc.collect()
    gc.freeze()  # set-up's objects out of the collector's scans in the window

    out = measure(cell, run, driver, state, args)
    driver.tail(state)
    if not args.trace:
        out["metrics"]["setup_s"] = {"value": setup_s, "unit": "s"}
    dev = common.device_info(cell.chips)
    if args.trace:
        dev["busy_s"], dev["window_s"] = out.pop("busy_s"), out.pop("window_s")

    gc.unfreeze()
    driver.release(state)
    gc.collect()
    torch.cuda.empty_cache()
    checks = driver.check(state)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or of the JAX package loaded: {found}", file=sys.stderr)
        return 4
    correct = all(c["ok"] for c in checks)
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r}) "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": out["metrics"], "device": dev}
    if "breakdown" in out:
        result["breakdown"] = out["breakdown"]
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
