"""Spans and counters of the port.

A span marks one piece of work at a layer boundary of the program: a
training step and its phases, a context refresh and its chunks, a serving
request and its tiles, an epoch of the engine. Spans record only while a
``torch.profiler`` session is on in the process: the benchmark's traced
sub-window and the CLI's ``--profile-dir``. Otherwise ``span`` costs one
check and returns a shared null context.

While a session is on, ``span(name, **counts)``

- enters ``torch.profiler.record_function("pmgt:" + name)``, so the span
  shows in every exported profiler trace beside the card's timeline;
- and appends a ``Span`` record to a bounded in-memory buffer: its name,
  start and end in ns on the clock the profiler stamps its events with
  (``time.time_ns()``, Unix time), its own id, its parent span's id, the
  id of its root span (one id per step, request or epoch) and its counts
  (``examples``, ``lanes``, ``nodes``, ``users``, ``items``).

A full buffer drops later records and counts them (``dropped()``);
``records()`` and ``clear()`` read and reset it. Nothing here synchronises
with the device or launches device work.

torch gives no cheap way to tell a session that records only the card's
activity from one that records the host's too: spans record under both.

Counters (``count``, ``counter``, ``counters``, ``reset_counters``) are
always on: named integers that the program increments where the work
happens, such as the hand-written kernels' launches
(``ops/dual_attention.py``).

Span names and their counts:

- training (``tasks/pmgt_task.py``, ``tasks/interaction_base.py``,
  ``train/optim.py``): ``batch`` (the step's inputs: its generator, the
  epoch's schedule, the pre-training batch's gathers), ``step``
  (``examples``), inside it ``forward`` (``lanes``: encoder sequences or
  scored pairs), ``backward`` and ``optimizer`` (``zero_grad``, the clip
  and the update);
- the refresh: ``refresh`` (``nodes``) around a training epoch's draw,
  with ``contexts`` (``nodes``, a chunk of ``sample_all_contexts``),
  ``pairs`` (``nodes``, a chunk of ``sample_all_pairs``) and PMGT_NCF's
  ``negatives`` inside;
- serving (``tasks/interaction_base.py``): ``serve`` (``users``), ``tile``
  (``items``: the catalogue items of the tile that exist), inside it
  ``forward`` (``lanes``: users × tile) and ``merge``;
- the engine (``train/engine.py``): ``epoch``, ``evaluate``; and each
  save of ``train/checkpoints.py``: ``checkpoint``.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import defaultdict
from contextlib import nullcontext
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.autograd.profiler import record_function

PREFIX = "pmgt:"
CAPACITY = 1 << 16  # records the buffer holds

_profiler_on = torch.autograd._profiler_enabled
_NULL = nullcontext()


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    root: int
    counts: Dict[str, int]


class _OpenSpans(threading.local):
    """The spans open in the calling thread, outermost first."""

    def __init__(self):
        self.stack: list = []


class _Buffer:
    """The records, the ids and, per thread, the open spans."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.records: List[Span] = []
        self.dropped = 0
        self.ids = itertools.count(1)
        self.open = _OpenSpans()

    def add(self, rec: Span) -> None:
        if len(self.records) < self.capacity:
            self.records.append(rec)
        else:
            self.dropped += 1


_BUFFER = _Buffer(CAPACITY)


class _Open:
    """One span while it is open."""

    __slots__ = ("name", "counts", "fn", "id", "parent", "root", "start")

    def __init__(self, name: str, counts: Dict[str, int]):
        self.name, self.counts = name, counts

    def __enter__(self):
        self.fn = record_function(PREFIX + self.name)
        self.fn.__enter__()
        stack = _BUFFER.open.stack
        self.id = next(_BUFFER.ids)
        self.parent = stack[-1].id if stack else None
        self.root = stack[0].id if stack else self.id
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _BUFFER.open.stack.pop()
        _BUFFER.add(Span(self.name, self.start, end, self.id, self.parent, self.root,
                         self.counts))
        return self.fn.__exit__(*exc)


def span(name: str, **counts: int):
    """A context manager around one piece of work (see the module's
    docstring); a shared null context while no profiler session is on."""
    if not _profiler_on():
        return _NULL
    return _Open(name, counts)


def records() -> List[Span]:
    """The spans recorded since the last ``clear()``, in the order they
    closed (a child before its parent)."""
    return list(_BUFFER.records)


def dropped() -> int:
    """Records the full buffer dropped since the last ``clear()``."""
    return _BUFFER.dropped


def clear() -> None:
    _BUFFER.records = []
    _BUFFER.dropped = 0


# ----------------------------------------------------------------------
# counters
# ----------------------------------------------------------------------

_COUNTERS: Dict[str, int] = defaultdict(int)


def count(name: str, n: int = 1) -> None:
    _COUNTERS[name] += n


def counter(name: str) -> int:
    return _COUNTERS.get(name, 0)


def counters() -> Dict[str, int]:
    return dict(_COUNTERS)


def reset_counters() -> None:
    _COUNTERS.clear()
