"""The program's own spans (``pmgt_tpu_torch/core/tracing.py``) against a
traced sub-window's device intervals, for the readers of per-layer metrics
that read them.

Attribution: each nanosecond of the window in which no device operation
runs goes to the innermost program span open on the host at that moment,
or to no span (``untraced``). A span's idle time is its interval's idle
time less its children's; the spans of one thread nest, so a span's
children lie inside it and apart from each other. ``X_idle_ms`` is the
idle time under spans named X and their children, in ms per unit of the
trace (step or request).

The records are ``tracing.records()``, put on the trace's clock, that
overlap the window. The program stamps them in Unix ns; a trace read from
the profiler's parsed events (torch 2.11) counts from the session's start.
So the offset between the two is fitted from the benchmark's spans around
the program's: each ``bench:step`` holds one program ``step``, each
``bench:refresh`` one ``refresh``, each ``bench:request`` one ``serve``.
Each pair bounds the offset from both sides. A step's bounds are tight on
both (nothing but the call runs between the two spans' starts and ends),
and the offset is the middle of the range in which every step nests. A
refresh and a request end after a device sync, so only their starts
bound it, and where no step is in the window the offset is their
tightest start bound: the program's span taken to start with the
benchmark's, which errs by the benchmark's own code before the call (tens to
hundreds of us). Without such pairs the clocks are taken as one. Everything here is silent (None) where the program has
no tracing module (an older checkout), where the window holds no record,
or where the program's buffer dropped records."""
from __future__ import annotations

from bisect import bisect_right
from typing import Dict, List, Optional


# (benchmark span, the program's root span inside each, whether its end
# bounds the offset as tightly as its start)
NESTED = (("step", "step", True), ("refresh", "refresh", False), ("request", "serve", False))


def offset_range(trace, recs) -> Optional[tuple]:
    """(lo, hi, tight): the offsets d in [lo, hi] move every benchmark
    span of ``NESTED`` onto the program's clock around its program span;
    ``tight``: whether a step bounds ``lo``. None without pairs."""
    lo = hi = None
    tight = False
    for outer, inner, both in NESTED:
        bench = sorted((s, e) for n, s, e in trace.spans if n == outer)
        prog = sorted((r.start_ns, r.end_ns) for r in recs
                      if r.name == inner and r.parent is None)
        if not bench or len(bench) != len(prog):
            continue
        ends = [pe - be for (_, be), (_, pe) in zip(bench, prog)]
        starts = [ps - bs for (bs, _), (ps, _) in zip(bench, prog)]
        hi = min(starts) if hi is None else min(hi, min(starts))
        if both:
            lo = max(ends) if lo is None else max(lo, max(ends))
            tight = True
        elif not tight:
            lo = max(ends) if lo is None else max(lo, max(ends))
    return None if hi is None else (lo, hi, tight)


def offset(trace, recs) -> int:
    """The offset of the program's clock from the trace's, in ns."""
    fit = offset_range(trace, recs)
    if fit is None:
        return 0
    lo, hi, tight = fit
    return (lo + hi) // 2 if tight else hi


def records(trace) -> Optional[list]:
    """The program's records on the trace's clock that overlap its
    window, or None."""
    try:
        from pmgt_tpu_torch.core import tracing
    except ImportError:
        return None
    if tracing.dropped():
        return None
    recs = tracing.records()
    d = offset(trace, recs)
    lo, hi = trace.window
    out = [r._replace(start_ns=r.start_ns - d, end_ns=r.end_ns - d) for r in recs
           if r.end_ns - d > lo and r.start_ns - d < hi]
    return out or None


class Idle:
    """The window's device-idle intervals: ``between(a, b)`` is the idle
    ns inside [a, b]."""

    def __init__(self, trace):
        lo, hi = self.lo, self.hi = trace.window
        gaps, end = [], lo
        for s, e in sorted((s, e) for _, s, e in trace.device):
            if s > end:
                gaps.append((end, min(s, hi)))
            end = max(end, e)
            if end >= hi:
                break
        if end < hi:
            gaps.append((end, hi))
        self.starts = [a for a, _ in gaps]
        self.gaps = gaps
        self.cum = [0]
        for a, b in gaps:
            self.cum.append(self.cum[-1] + b - a)

    @property
    def total(self) -> int:
        return self.cum[-1]

    def _upto(self, t: int) -> int:
        i = bisect_right(self.starts, t)
        if i == 0:
            return 0
        a, b = self.gaps[i - 1]
        return self.cum[i - 1] + min(t, b) - a

    def between(self, a: int, b: int) -> int:
        a, b = max(a, self.lo), min(b, self.hi)
        return self._upto(b) - self._upto(a) if b > a else 0


def self_idle(trace, recs: List) -> tuple:
    """({record id: idle ns of its own, children's left out}, untraced
    idle ns)."""
    idle = Idle(trace)
    ids = {r.id for r in recs}
    own = {r.id: idle.between(r.start_ns, r.end_ns) for r in recs}
    untraced = idle.total
    for r in recs:
        if r.parent in ids:
            own[r.parent] -= idle.between(r.start_ns, r.end_ns)
        else:
            untraced -= idle.between(r.start_ns, r.end_ns)
    return own, untraced


def phase_of(recs: List, names) -> Dict[int, Optional[str]]:
    """{record id: the name in ``names`` of the record or of its nearest
    ancestor that has one, else None}."""
    by_id = {r.id: r for r in recs}
    out: Dict[int, Optional[str]] = {}
    for r in recs:
        x = r
        while x is not None and x.name not in names:
            x = by_id.get(x.parent)
        out[r.id] = x.name if x is not None else None
    return out


def idle_ms_under(trace, name: str) -> Optional[float]:
    """Idle ms a unit under spans named ``name`` and their children; None
    where no such span lies in the window."""
    if not trace.device or trace.units <= 0:
        return None
    recs = records(trace)
    if recs is None or not any(r.name == name for r in recs):
        return None
    own, _ = self_idle(trace, recs)
    phase = phase_of(recs, {name})
    return sum(ns for i, ns in own.items() if phase[i] == name) / 1e6 / trace.units


def untraced_idle_ms(trace) -> Optional[float]:
    """Idle ms a unit under no program span."""
    if not trace.device or trace.units <= 0:
        return None
    recs = records(trace)
    if recs is None:
        return None
    return self_idle(trace, recs)[1] / 1e6 / trace.units
