"""The traced sub-window: one ``torch.profiler`` session over a driver's
steady work, reduced to device intervals and the benchmark's own spans.

The profiler reader is a frozen copy, reworked, of ``profile_phases`` in
``chip_smoke.py`` (sha256 07ee127fb595b8ccdbaac2fb87e77fb38030a3d6eddd2e
033d06f01f0c53df4e): device events are those the profiler puts on a CUDA
device, annotations (the benchmark's ``bench:<name>`` spans, the
optimizer's ``Optimizer.step``) left out; K1 and K2 are recognised by
``KERNEL_NAMES``. A traced sub-window's events are read raw from the
profiler's results where a raw event tells its activity type, and else
from the parsed events (some 200 us each on torch 2.11). ``DeviceTrace``
records the card alone over a whole timed window and always reads its
events raw.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

KERNEL_NAMES = {"k1": "dual_attention_fwd_kernel", "k2": "dual_attention_bwd_kernel"}
SPAN_PREFIX = "bench:"
# Seconds of one profiler session over a timed window: the profiler keeps a
# session's records in buffers of bounded size and drops what comes after,
# and a pre-training step records some 850 device operations.
SESSION_S = 4.0

Interval = Tuple[str, int, int]  # (name, start ns, end ns)


@contextmanager
def span(name: str):
    """A benchmark span around a call into one layer of the program."""
    from torch.profiler import record_function

    with record_function(SPAN_PREFIX + name):
        yield


@dataclass
class Trace:
    """What a traced sub-window saw. ``units``: the steps or requests the
    driver completed in it; ``counts``: the driver's own numbers (work
    counts, recorded kernel shapes) for the metric readers."""

    window: Tuple[int, int]
    device: List[Interval]
    spans: List[Interval]
    units: int
    counts: Dict[str, object] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_s(self) -> float:
        """Seconds in which some device operation ran: the union of the
        device intervals inside the window."""
        lo, hi = self.window
        total, end = 0, lo
        for _, s, e in sorted(self.device, key=lambda x: x[1]):
            s, e = max(s, end), min(e, hi)
            if e > s:
                total += e - s
                end = e
        return total / 1e9

    def kernel_time_s(self, key: str) -> Tuple[int, float]:
        """(launches, summed device seconds) of kernel ``key`` (k1, k2)."""
        name = KERNEL_NAMES[key]
        mine = [e - s for n, s, e in self.device if name in n]
        return len(mine), sum(mine) / 1e9

    def span_time_s(self, name: str) -> float:
        return sum(e - s for n, s, e in self.spans if n == name) / 1e9

    def device_ops(self, top: int = 10) -> List[List]:
        by_name: Dict[str, int] = {}
        for n, s, e in self.device:
            by_name[n] = by_name.get(n, 0) + (e - s)
        ranked = sorted(by_name.items(), key=lambda x: -x[1])[:top]
        return [[n, t / 1e9] for n, t in ranked]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """The longest device-idle gaps in the window, each named by the
        innermost benchmark span open on the host at the gap's middle."""
        lo, hi = self.window
        gaps, end = [], lo
        for _, s, e in sorted(self.device, key=lambda x: x[1]):
            if s > end:
                gaps.append((end, min(s, hi)))
            end = max(end, e)
        if hi > end:
            gaps.append((end, hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:top]:
            mid = (a + b) // 2
            open_ = [x for x in self.spans if x[1] <= mid <= x[2]]
            name = min(open_, key=lambda x: x[2] - x[1])[0] if open_ else "outside spans"
            out.append([name, (b - a) / 1e9])
        return out


def _raw_events(prof):
    """(name, device type name, start ns, end ns, is an annotation) of
    every event. Annotations (``record_function`` ranges, the optimizer's
    among them) are mirrored onto the device's timeline but are no device
    work."""
    try:
        events = prof.profiler.kineto_results.events()
        return [(e.name(), str(e.device_type()), e.start_ns(), e.start_ns() + e.duration_ns(),
                 e.is_user_annotation() or "annotation" in str(e.activity_type()))
                for e in events]
    except AttributeError:  # older results: the parsed events
        return [(e.name, str(e.device_type), int(e.time_range.start * 1000),
                 int(e.time_range.end * 1000), e.is_user_annotation) for e in prof.events()]


def traced(run: Callable[[], Tuple[int, Dict[str, object]]], use_cuda: bool) -> Trace:
    """Profile ``run()`` (which returns (units, counts) and ends its work
    in a device sync) inside a ``bench:window`` span."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if use_cuda else [])
    with profile(activities=acts) as prof:
        with span("window"):
            units, counts = run()
    device, spans, window = [], [], None
    for name, dev, s, e, note in _raw_events(prof):
        if name.startswith(SPAN_PREFIX):
            if "CPU" in dev:
                if name == SPAN_PREFIX + "window":
                    window = (s, e)
                else:
                    spans.append((name[len(SPAN_PREFIX):], s, e))
        elif "CUDA" in dev and not note:
            device.append((name, s, e))
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    return Trace(window=window, device=device, spans=spans, units=units, counts=counts)


def _begin_device_session():
    """Start the profiler on the card's activity alone."""
    from torch.autograd.profiler import profile

    prof = profile(use_device="cuda", use_kineto=True, use_cpu=False)
    prof.__enter__()
    return prof


def _end_device_session(prof):
    """Stop the profiler and return its raw results. The profiler's own
    exit may first build a Python event of every record, which over a long
    window takes minutes; the raw results are read after the window."""
    from torch.autograd import _disable_profiler

    prof.enabled = False  # its exit, were it called, now does nothing
    return _disable_profiler()


def _device_rows(results) -> List[Interval]:
    """The device operations of a session's raw results, annotations left
    out."""
    rows = []
    for e in results.events():
        if "CUDA" not in str(e.device_type()) or e.name().startswith(SPAN_PREFIX):
            continue
        if e.is_user_annotation():
            continue
        rows.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return rows


class DeviceTrace:
    """The card's activity over a timed window of any length, for the
    end-to-end metrics read from the device trace. Only the card's
    activity is recorded, which keeps the profiler's cost to the host
    small. The window is profiled in sessions of at most ``session_s``
    seconds: ``tick()``, which the driver calls between its units, ends a
    session that has run that long, after a device sync, and starts the
    next, so that no session outgrows the profiler's buffers. Each
    session's records are read once the window is over."""

    def __init__(self, sync: Callable[[], None], session_s: float = SESSION_S):
        self.sync, self.session_s = sync, session_s
        self._results: list = []
        self._prof = None
        self._t0 = 0.0

    def _start(self) -> None:
        self._prof = _begin_device_session()
        self._t0 = time.perf_counter()

    def _stop(self) -> None:
        self.sync()
        prof, self._prof = self._prof, None
        self._results.append(_end_device_session(prof))

    def tick(self) -> None:
        if time.perf_counter() - self._t0 >= self.session_s:
            self._stop()
            self._start()

    def run(self, window: Callable[[Callable[[], None]], int]) -> Trace:
        """Profile ``window(tick)``, which returns the units it completed;
        the trace's window runs from the first device operation to the
        end of the last."""
        self._start()
        try:
            units = window(self.tick)
        finally:
            self._stop()
        device = [row for results in self._results for row in _device_rows(results)]
        self._results = []
        if not device:
            raise RuntimeError("the profiler recorded no device operation in the window")
        start = min(s for _, s, _ in device)
        end = max(e for _, _, e in device)
        return Trace(window=(start, end), device=device, spans=[], units=units)
