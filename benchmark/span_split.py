"""The card's idle time of one cell's traced sub-window, split by the
program's spans, on the card:

    python3 benchmark/span_split.py --workload <cell> --seed <n> [--window 1]

One JSON line: the idle ms a unit by phase (``batch``, ``forward``,
``backward``, ``optimizer``, ``refresh``, the other spans and no span) and
by the innermost span's name, the split's sum against the window's idle
time, each span's counts a unit, the traced per-layer metrics, and where
the program's root spans
(``step``, ``refresh``, ``serve``) lie inside the benchmark's spans around
them, in us on the profiler's own clock (its raw events): the start after
the benchmark span's start, the end before its end. With ``--window 1`` a
timed window of ``--seconds`` runs first under the card-only session of
the end-to-end metrics, and the line gives the records the program left
in it. Set-up as ``run.py``'s; no check of ``correct``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

PHASES = ("batch", "forward", "backward", "optimizer", "refresh")


def split(trace, recs) -> dict:
    """The idle ms a unit by phase and by span name, and the window's."""
    from benchmark.metrics import _program_spans as ps

    own, untraced = ps.self_idle(trace, recs)
    phase = ps.phase_of(recs, set(PHASES))
    names = {r.id: r.name for r in recs}
    per = 1e6 * trace.units
    by_phase = {p: 0.0 for p in PHASES + ("other",)}
    by_name: dict = {}
    for i, ns in own.items():
        by_phase[phase[i] or "other"] += ns / per
        by_name[names[i]] = by_name.get(names[i], 0.0) + ns / per
    by_phase["untraced"] = untraced / per
    idle = ps.Idle(trace).total / per
    return {"by_phase": by_phase, "by_name": by_name, "idle_ms": idle,
            "sum_error": sum(by_phase.values()) / idle - 1.0 if idle else None}


def counts(trace, recs) -> dict:
    """{span name: {count: its sum a unit}}: the work each kind of span
    did a step or request (``examples``, ``lanes``, ``nodes``, ``users``,
    ``items``)."""
    out: dict = {}
    for r in recs:
        for k, v in r.counts.items():
            out.setdefault(r.name, {}).setdefault(k, 0)
            out[r.name][k] += v
    return {n: {k: v / trace.units for k, v in c.items()} for n, c in out.items()}


def nesting(events, recs) -> dict:
    """For each root span kind of ``_program_spans.NESTED``, where the
    program's spans lie inside the benchmark's, from the profiler's raw
    events ``events`` = [(name, start ns, end ns)] of the benchmark's
    spans: count, median and worst (smallest) start and end margins in
    us; a negative margin lies outside."""
    from benchmark.harness.trace import SPAN_PREFIX
    from benchmark.metrics._program_spans import NESTED

    out = {}
    for outer, inner, _ in NESTED:
        bench = sorted((s, e) for n, s, e in events if n == SPAN_PREFIX + outer)
        starts, ends = [], []
        for r in recs:
            if r.name != inner or r.parent is not None:
                continue
            mid = (r.start_ns + r.end_ns) // 2
            box = [b for b in bench if b[0] <= mid <= b[1]]
            if box:
                starts.append((r.start_ns - box[0][0]) / 1e3)
                ends.append((box[0][1] - r.end_ns) / 1e3)
        if starts:
            out[inner] = {"n": len(starts), "start_us_median": statistics.median(starts),
                          "start_us_min": min(starts), "end_us_median": statistics.median(ends),
                          "end_us_min": min(ends)}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--window", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark import run as brun

    brun.environment()
    import torch
    import torch.profiler

    from benchmark.harness import common, spec
    from benchmark.harness import trace as trace_mod
    from benchmark.metrics import _program_spans as ps
    from pmgt_tpu_torch.core import tracing

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    torch.set_num_threads(brun.HOST_THREADS)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cell = spec.find_cell(spec.load_benchmark(ROOT), args.workload, ROOT)
    driver = spec.load_driver(cell.traffic["driver"])
    state = driver.setup(brun.Run(cell, args.seed, device))
    common.sync(device)
    out = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(0)}
    if args.window:
        tracing.clear()
        names = [m["name"] for m in cell.end_to_end if m["source"] == "device_trace"]
        res = brun.timed_window(cell, driver, state, args.seconds, device)
        out["window"] = {"units": res["attempted"], "records": len(tracing.records()),
                         "dropped": tracing.dropped(),
                         "metrics": {n: res["metrics"][n] for n in names}}
    tracing.clear()
    profiles = []

    class Kept(torch.profiler.profile):  # the traced run's profiler, for its raw events
        def __enter__(self):
            profiles.append(self)
            return super().__enter__()

    real, torch.profiler.profile = torch.profiler.profile, Kept
    try:
        tr = trace_mod.traced(driver.traced(state, cell.traffic), True)
    finally:
        torch.profiler.profile = real
    out["per_layer"] = {k: v["value"] for k, v in spec.read_per_layer(cell, tr).items()}
    out["units"], out["window_s"], out["busy_s"] = tr.units, tr.window_s, tr.busy_s()
    raw = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in profiles[0].profiler.kineto_results.events()
           if e.name().startswith(trace_mod.SPAN_PREFIX) and "CPU" in str(e.device_type())]
    recs = tracing.records()
    out["records"], out["dropped"] = len(recs), tracing.dropped()
    out["nesting"] = nesting(raw, recs)
    fit = ps.offset_range(tr, recs)
    if fit is not None:  # the fitted offset against the one the raw events give
        (win,) = [s for n, s, _ in raw if n == trace_mod.SPAN_PREFIX + "window"]
        out["offset_fit"] = {"range_us": (fit[1] - fit[0]) / 1e3, "from_steps": fit[2],
                             "error_us": (ps.offset(tr, recs) - (win - tr.window[0])) / 1e3}
    on_clock = ps.records(tr)
    if on_clock:
        out.update(split(tr, on_clock))
        out["counts"] = counts(tr, on_clock)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
