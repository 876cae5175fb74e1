"""The readers of the program's spans on traces and records made by hand:
the card's idle time split over the program's phases, the untraced time
and the other spans adds up to the trace's; silence where there is
nothing to read; the ratio of encoder lanes to catalogue items."""
from __future__ import annotations

import sys

import numpy as np
import pytest

from benchmark.harness import spec
from benchmark.harness.trace import Trace
from pmgt_tpu_torch.core import tracing

MS = 1_000_000  # ns
PHASES = ("batch", "forward", "backward", "optimizer", "refresh")
READERS = ["batch_idle_ms.pretrain", "forward_idle_ms.pretrain", "backward_idle_ms.pretrain",
           "optimizer_idle_ms.pretrain", "refresh_idle_ms.pretrain", "untraced_idle_ms.pretrain",
           "encoder_lanes_per_item.serve"]


def _read(name, trace):
    return spec.load_metric_reader(name).read(trace)


@pytest.fixture
def program(monkeypatch):
    """``program(recs, dropped=0)`` puts ``recs`` in the program's buffer
    for the readers."""
    def put(recs, dropped=0):
        monkeypatch.setattr(tracing, "records", lambda: list(recs))
        monkeypatch.setattr(tracing, "dropped", lambda: dropped)
    return put


class _Recorder:
    """Spans laid out by hand: ``open``/``close`` with times in ms."""

    def __init__(self):
        self.recs, self.stack, self.next = [], [], 1

    def open(self, name, t, **counts):
        parent = self.stack[-1] if self.stack else None
        rec = [name, t, None, self.next, parent and parent[3], parent[5] if parent else self.next,
               counts]
        self.next += 1
        self.stack.append(rec)

    def close(self, t):
        rec = self.stack.pop()
        rec[2] = t
        name, s, e, i, p, r, c = rec
        self.recs.append(tracing.Span(name, int(s * MS), int(e * MS), i, p, r, c))


def _steps(rng, units):
    """A window of ``units`` training steps in 100 ms, with a refresh
    first and the caller's own code between: a random lay-out of the
    spans and of the device's intervals."""
    rec = _Recorder()
    t = 1.0
    rec.open("refresh", t, nodes=100)
    for name in ("contexts", "contexts", "pairs"):
        rec.open(name, t + 0.1)
        t += rng.uniform(0.5, 2.0)
        rec.close(t)
    t += 0.2
    rec.close(t)
    for _ in range(units):
        t += rng.uniform(0.1, 1.0)  # the caller's code
        rec.open("batch", t)
        t += rng.uniform(0.1, 1.0)
        rec.close(t)
        rec.open("step", t + 0.05, examples=8)
        t += 0.1
        for name in ("optimizer", "batch", "forward", "backward", "optimizer"):
            rec.open(name, t, **({"lanes": 48} if name == "forward" else {}))
            t += rng.uniform(0.5, 3.0)
            rec.close(t)
            t += rng.uniform(0.0, 0.3)  # the step's own code between its phases
        rec.close(t)
    assert t < 99.0
    starts = np.sort(rng.uniform(0, 100, 60))
    device = [("op", int(s * MS), int((s + rng.uniform(0.01, 2.0)) * MS)) for s in starts]
    # the benchmark's spans around the program's refresh and steps, 20 us wider
    bench = [(r.name, r.start_ns - 20_000, r.end_ns + 20_000) for r in rec.recs
             if r.name in ("refresh", "step")]
    trace = Trace(window=(0, 100 * MS), device=device, spans=bench, units=units, counts={})
    return trace, rec.recs


@pytest.mark.parametrize("seed", range(6))
def test_the_split_adds_up_to_the_idle_time(program, seed):
    """The phases, the untraced time and the idle under the other spans
    (the steps' and the refresh's own code left to them) make the card's
    idle ms a unit, within 1e-9."""
    from benchmark.metrics import _program_spans as ps

    trace, recs = _steps(np.random.default_rng(seed), units=5)
    program(recs)
    parts = {p: _read(f"{p}_idle_ms.pretrain", trace) for p in PHASES}
    untraced = _read("untraced_idle_ms.pretrain", trace)
    own, _ = ps.self_idle(trace, recs)
    phase = ps.phase_of(recs, set(PHASES))
    other = sum(ns for i, ns in own.items() if phase[i] is None) / 1e6 / trace.units
    idle = _read("device_idle.pretrain", trace) / 100 * trace.window_s * 1e3 / trace.units
    assert all(v is not None and v >= 0 for v in parts.values()) and untraced > 0 and other > 0
    assert sum(parts.values()) + untraced + other == pytest.approx(idle, rel=1e-9)


@pytest.mark.parametrize("base", [0, 1_760_000_000_000_000_000])
def test_records_go_on_the_traces_clock(program, base):
    """A trace that counts from the profiler session's start and records
    stamped in Unix ns: the benchmark's spans around the program's give
    the offset, and every reader reads what it reads on one clock."""
    trace, recs = _steps(np.random.default_rng(7), units=5)
    program(recs)
    want = {n: _read(n, trace) for n in READERS[:-1]}
    program([r._replace(start_ns=r.start_ns + base, end_ns=r.end_ns + base) for r in recs])
    assert {n: _read(n, trace) for n in READERS[:-1]} == pytest.approx(want, rel=1e-12)


def test_serving_is_put_on_the_clock_by_its_requests_starts(program):
    """Requests end after the reply's copy waits for the card, so only
    their starts bound the offset: the program's ``serve`` is taken to
    start with its request, 50 us early here, and the lanes read as on
    one clock."""
    from benchmark.metrics import _program_spans as ps

    trace, recs = _serving(users=64, chunk=1024, items=10_834)
    trace.spans = [("request", r.start_ns - 50_000, r.end_ns + 3 * MS) for r in recs
                   if r.name == "serve"]
    base = 1_760_000_000_000_000_000
    moved = [r._replace(start_ns=r.start_ns + base, end_ns=r.end_ns + base) for r in recs]
    assert ps.offset(trace, moved) - base == 50_000
    program(moved)
    assert _read("encoder_lanes_per_item.serve", trace) == pytest.approx(64 * 11 * 1024 / 10_834)


def test_the_innermost_span_takes_the_gap(program):
    """Device busy over [0, 10] and [50, 100] ms of a 100-ms window; a step
    over [20, 70] with a forward over [30, 40] and a backward over [45, 60]:
    the forward has 10 ms, the backward 5 ms, the step's own code 15 ms
    and no span 10 ms."""
    rec = _Recorder()
    rec.open("step", 20)
    rec.open("forward", 30)
    rec.close(40)
    rec.open("backward", 45)
    rec.close(60)
    rec.close(70)
    program(rec.recs)
    trace = Trace(window=(0, 100 * MS), device=[("a", 0, 10 * MS), ("b", 50 * MS, 100 * MS)],
                  spans=[], units=2, counts={})
    assert _read("forward_idle_ms.pretrain", trace) == pytest.approx(5.0)
    assert _read("backward_idle_ms.pretrain", trace) == pytest.approx(2.5)
    assert _read("untraced_idle_ms.pretrain", trace) == pytest.approx(5.0)
    assert _read("batch_idle_ms.pretrain", trace) is None  # no batch span in the window


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("why", ["no records", "records dropped", "outside the window",
                                 "no tracing module"])
def test_silent_where_there_is_nothing_to_read(program, monkeypatch, name, why):
    trace, recs = _steps(np.random.default_rng(0), units=5)
    if name.startswith("encoder_lanes_per_item"):
        trace, recs = _serving(users=4, chunk=30, items=100)
    if why == "no records":
        recs = []
    elif why == "outside the window":
        trace = Trace(window=(200 * MS, 300 * MS), device=[("op", 210 * MS, 220 * MS)], spans=[],
                      units=1, counts={})
    elif why == "no tracing module":  # a checkout of the program from before it
        import pmgt_tpu_torch.core

        monkeypatch.delattr(pmgt_tpu_torch.core, "tracing")
        monkeypatch.setitem(sys.modules, "pmgt_tpu_torch.core.tracing", None)
    program(recs, dropped=3 if why == "records dropped" else 0)
    assert _read(name, trace) is None


def _serving(users, chunk, items, requests=2):
    rec = _Recorder()
    t = 1.0
    for _ in range(requests):
        rec.open("serve", t, users=users)
        for start in range(0, items, chunk):
            rec.open("tile", t, items=min(chunk, items - start))
            rec.open("forward", t, lanes=users * chunk)
            t += 0.5
            rec.close(t)
            rec.open("merge", t)
            t += 0.5
            rec.close(t)
            rec.close(t)
        rec.close(t)
    trace = Trace(window=(0, int((t + 1) * MS)), device=[("op", 0, MS)], spans=[],
                  units=requests, counts={})
    return trace, rec.recs


@pytest.mark.parametrize("users,chunk,items,want", [
    (64, 1024, 10_834, 64 * 11 * 1024 / 10_834),  # the sweep: 66.5, the padding counted
    (1, 10_834, 10_834, 1.0),  # one user, the catalogue as one tile
])
def test_encoder_lanes_per_item(program, users, chunk, items, want):
    trace, recs = _serving(users, chunk, items)
    program(recs)
    assert _read("encoder_lanes_per_item.serve", trace) == pytest.approx(want, rel=1e-12)


def test_lanes_outside_serving_are_not_counted(program):
    """A training step's ``forward`` lanes in the window count for nothing."""
    trace, recs = _serving(1, 50, 100)
    rec = _Recorder()
    rec.next = 1000
    rec.open("step", 0.1)
    rec.open("forward", 0.2, lanes=5000)
    rec.close(0.3)
    rec.close(0.4)
    program(recs + rec.recs)
    assert _read("encoder_lanes_per_item.serve", trace) == pytest.approx(1.0)


@pytest.mark.parametrize("cell,want", [
    # 150 items in three 64-item tiles: the program encodes each item once
    # a request, before the tiles, whatever the users and the tile size
    ("pmgt_ncf-tg.serve", 1.0),
    ("pmgt_ncf-tg.serve-1user", 1.0),
])
def test_a_tiny_traced_serving_run_reads_its_lanes(cell, want):
    """On the CPU, through the cell's traced sub-window: the program's
    spans give the ratio (the idle times need the card's intervals)."""
    from benchmark.tests import tiny

    tracing.clear()
    try:
        result, _, _ = tiny.drive(cell, trace=True)
    finally:
        tracing.clear()
    name = "encoder_lanes_per_item." + ("serve" if cell.endswith(".serve") else "online")
    assert result["metrics"][name]["value"] == pytest.approx(want, rel=1e-12)
    # the users the traced requests served, for users_per_s (tiny.py traces two requests)
    per_request = spec.find_cell(spec.load_benchmark(), cell).traffic["users_per_request"]
    assert result["trace"].counts["users"] == 2 * per_request
    assert not any(n.split(".")[0].endswith("_idle_ms") for n in result["metrics"])


def test_span_split_of_a_hand_made_window():
    """``span_split.py``'s split and counts: the phases, the other spans
    and no span make the window's idle time; counts a unit."""
    from benchmark import span_split

    trace, recs = _steps(np.random.default_rng(3), units=5)
    out = span_split.split(trace, recs)
    assert out["sum_error"] == pytest.approx(0.0, abs=1e-12)
    assert sum(out["by_name"].values()) + out["by_phase"]["untraced"] == pytest.approx(
        out["idle_ms"], rel=1e-12)
    assert span_split.counts(trace, recs) == {"refresh": {"nodes": 20.0},
                                              "step": {"examples": 8.0},
                                              "forward": {"lanes": 48.0}}
    events = [("bench:step", r.start_ns - 1000, r.end_ns + 2000) for r in recs if r.name == "step"]
    nest = span_split.nesting(events, recs)["step"]
    assert (nest["n"], nest["start_us_min"], nest["end_us_min"]) == (5, 1.0, 2.0)
