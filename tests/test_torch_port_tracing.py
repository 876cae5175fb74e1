"""The port's spans and counters (``pmgt_tpu_torch.core.tracing``) on the
CPU: off without a profiler session, recorded under one with their ids,
parents, roots and counts, on the profiler's own clock; the bounded
buffer; the spans of a PMGT pre-training step with its refresh, of a
PMGT_NCF training step with its refresh, and of a PMGT_NCF serving sweep;
the counters the kernels' launches go to."""
from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pmgt_tpu_torch.core import tracing
from pmgt_tpu_torch.core.config import TrainArgs
from pmgt_tpu_torch.data import interactions
from pmgt_tpu_torch.data.split import train_test_split
from pmgt_tpu_torch.data.synthetic import make_synthetic_dataset
from pmgt_tpu_torch.ops.dual_attention import launch_counts
from pmgt_tpu_torch.tasks.pmgt_ncf_task import PMGTNCFTask
from pmgt_tpu_torch.tasks.pmgt_task import PMGTTask

ENCODER = dict(hidden_size=16, intermediate_size=16, num_hidden_layers=1,
               hop_sampling_sizes=(4, 2))
NUM_NODES = 37


@pytest.fixture
def fresh():
    """An empty buffer before the test and after it."""
    tracing.clear()
    yield
    tracing.clear()


def _profiled(fn):
    """(fn's result, the profiler's ``pmgt:`` events as {name: [(start
    ns, end ns)]}) of ``fn()`` under a CPU profiler session."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(tracing.PREFIX):
            events.setdefault(e.name()[len(tracing.PREFIX):], []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    return out, events


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r.name, []).append(r)
    return out


@pytest.mark.parametrize("counts", [{}, {"lanes": 3}, {"examples": 256, "nodes": 10_836}])
def test_off_without_a_profiler(fresh, counts):
    """No session: the shared null context, nothing recorded."""
    ctx = tracing.span("step", **counts)
    assert ctx is tracing.span("forward")
    with ctx:
        torch.ones(3).sum()
    assert tracing.records() == [] and tracing.dropped() == 0


def test_records_nest_under_a_profiler(fresh):
    def work():
        with tracing.span("step", examples=4):
            with tracing.span("forward", lanes=12):
                torch.ones(8) @ torch.ones(8)
            with tracing.span("backward"):
                pass
        with tracing.span("step", examples=4):
            pass

    _profiled(work)
    fwd, bwd, step1, step2 = tracing.records()  # in the order they closed
    assert [r.name for r in (fwd, bwd, step1, step2)] == ["forward", "backward", "step", "step"]
    assert (step1.parent, step1.root) == (None, step1.id)
    assert (fwd.parent, fwd.root, bwd.parent, bwd.root) == (step1.id,) * 4
    assert (step2.parent, step2.root) == (None, step2.id)
    assert len({step1.id, fwd.id, bwd.id, step2.id}) == 4
    assert (step1.counts, fwd.counts, bwd.counts) == ({"examples": 4}, {"lanes": 12}, {})
    assert step1.start_ns <= fwd.start_ns <= fwd.end_ns <= bwd.start_ns <= bwd.end_ns <= step1.end_ns
    assert step1.end_ns <= step2.start_ns


@pytest.mark.parametrize("depth", [1, 3])
def test_intervals_lie_on_the_profilers_clock(fresh, depth):
    """After the first span, each record lies within 1 ms of the
    profiler's own event for the same span, at both ends."""
    def nest(level):
        with tracing.span(f"s{level}"):
            torch.randn(64, 64) @ torch.randn(64, 64)
            if level + 1 < depth:
                nest(level + 1)

    def work():
        for _ in range(6):
            nest(0)

    _, events = _profiled(work)
    recs = _by_name(tracing.records())
    assert set(recs) == set(events) == {f"s{i}" for i in range(depth)}
    for name, rs in recs.items():
        evs = sorted(events[name])
        rs = sorted(rs, key=lambda r: r.start_ns)
        assert len(rs) == len(evs) == 6
        for r, (s, e) in list(zip(rs, evs))[1:]:
            assert abs(r.start_ns - s) < 1_000_000 and abs(r.end_ns - e) < 1_000_000


def test_a_full_buffer_drops_and_counts(fresh, monkeypatch):
    monkeypatch.setattr(tracing._BUFFER, "capacity", 3)

    def work():
        for i in range(5):
            with tracing.span("tile", items=i):
                pass

    _profiled(work)
    assert [r.counts["items"] for r in tracing.records()] == [0, 1, 2]
    assert tracing.dropped() == 2
    tracing.clear()
    assert tracing.records() == [] and tracing.dropped() == 0


def test_counters_and_the_launch_counts():
    tracing.reset_counters()
    assert launch_counts() == {"k1": 0, "k2": 0, "k3": 0, "k4": 0}
    tracing.count("k1_launches")
    tracing.count("k2_launches", 5)
    assert tracing.counter("k2_launches") == 5 and tracing.counter("nothing") == 0
    assert launch_counts() == {"k1": 1, "k2": 5, "k3": 0, "k4": 0}
    assert tracing.counters() == {"k1_launches": 1, "k2_launches": 5}
    tracing.reset_counters()
    assert tracing.counters() == {}


# ----------------------------------------------------------------------
# the tasks
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def artifacts():
    return make_synthetic_dataset(num_nodes=NUM_NODES, num_users=11, feat_dims=(12, 8),
                                  avg_degree=4, interactions_per_user=4, seed=5)


def _pmgt_task(art):
    nodes = np.arange(2, NUM_NODES + 2, dtype=np.int32)
    train, valid = train_test_split(nodes, 0.2, 1)
    args = TrainArgs(seed=1, train_batch_size=8, extra=dict(ENCODER, max_total_samples=4,
                                                            min_neg_samples=2))
    return PMGTTask(args, art, train, valid, device="cpu")


def _pmgt_ncf_task(art):
    pairs = art.train_pairs
    data = [interactions.InteractionData.build(p, art.num_users, art.num_items)
            for p in (pairs, pairs[::2], pairs[1::2])]
    args = TrainArgs(seed=2, train_batch_size=8, model_name="NeuMF-end",
                     extra=dict(ENCODER, factor_num=4, num_layers=2, num_ng=1))
    return PMGTNCFTask(args, art, *data, device="cpu")


def test_a_pretraining_step_and_its_refresh(fresh, artifacts):
    task = _pmgt_task(artifacts)

    def work():
        task.on_epoch_start(0)
        for batch in task.train_batches(0):
            task.train_step(batch)
            break

    _profiled(work)
    recs = tracing.records()
    by = _by_name(recs)
    ids = {r.id: r for r in recs}
    (refresh,), (step,) = by["refresh"], by["step"]
    n_total = NUM_NODES + 2
    assert refresh.counts == {"nodes": n_total} and refresh.parent is None
    assert all(r.parent == refresh.id for r in by["contexts"] + by["pairs"])
    assert sum(r.counts["nodes"] for r in by["contexts"]) == n_total
    assert sum(r.counts["nodes"] for r in by["pairs"]) == n_total
    assert step.counts == {"examples": 8} and step.parent is None
    (fwd,), (bwd,) = by["forward"], by["backward"]
    assert fwd.counts == {"lanes": 8 * (2 + 4)} and fwd.parent == bwd.parent == step.id
    # zero_grad before the forward, the clip and the update after the backward
    opt = sorted(by["optimizer"], key=lambda r: r.start_ns)
    assert [r.parent for r in opt] == [step.id, step.id]
    assert opt[0].end_ns <= fwd.start_ns and bwd.end_ns <= opt[1].start_ns
    # the schedule and the step's generator outside the step, its gathers inside
    outer = [r for r in by["batch"] if r.parent is None]
    inner = [r for r in by["batch"] if r.parent == step.id]
    assert len(outer) == 2 and len(inner) == 1
    assert all(r.end_ns <= step.start_ns for r in outer)
    assert {ids[r.root].name for r in recs} == {"refresh", "batch", "step"}


def test_a_pmgt_ncf_step_and_its_refresh(fresh, artifacts):
    task = _pmgt_ncf_task(artifacts)

    def work():
        for batch in task.train_batches(0):
            task.train_step(batch)
            break

    _profiled(work)
    by = _by_name(tracing.records())
    (refresh,), (neg,), (step,), (fwd,), (bwd,), (batch,) = (
        by[n] for n in ("refresh", "negatives", "step", "forward", "backward", "batch"))
    assert refresh.counts == {"nodes": NUM_NODES + 2} and neg.parent == refresh.id
    assert all(r.parent == refresh.id for r in by["contexts"])
    assert batch.parent is None and refresh.end_ns <= batch.start_ns <= batch.end_ns <= step.start_ns
    assert step.counts == {"examples": 8} and fwd.counts == {"lanes": 8}
    assert fwd.parent == bwd.parent == step.id
    assert [r.parent for r in by["optimizer"]] == [step.id, step.id]


@pytest.mark.parametrize("users,chunk", [(3, 16), (1, NUM_NODES)])
def test_a_serving_request(fresh, artifacts, users, chunk):
    task = _pmgt_ncf_task(artifacts)
    score = task.scorer()
    pos = torch.as_tensor(task.positives(), dtype=torch.int64)
    u = torch.arange(users, dtype=torch.int64)
    _profiled(lambda: task.serve_users(score, u, pos[u], 5, chunk))
    recs = tracing.records()
    by = _by_name(recs)
    (serve,) = by["serve"]
    tiles = by["tile"]
    assert serve.counts == {"users": users} and len(tiles) == -(-NUM_NODES // chunk)
    assert all(t.parent == serve.id and t.root == serve.id for t in tiles)
    assert sum(t.counts["items"] for t in tiles) == NUM_NODES  # the padding left out
    for kind in ("forward", "merge"):
        assert sorted(r.parent for r in by[kind]) == sorted(t.id for t in tiles)
    assert all(r.counts == {"lanes": users * chunk} for r in by["forward"])
    assert {r.root for r in recs} == {serve.id}


def test_nothing_recorded_off(fresh, artifacts):
    """The tasks record nothing without a profiler session."""
    task = _pmgt_task(artifacts)
    task.train_epoch(0)
    assert tracing.records() == [] and tracing.dropped() == 0
