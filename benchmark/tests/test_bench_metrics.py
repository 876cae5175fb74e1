"""The per-layer readers on traces made by hand: silent where there is
nothing to read, and the arithmetic of each share."""
from __future__ import annotations

import pytest

from benchmark.harness import spec
from benchmark.harness.trace import KERNEL_NAMES, Trace
from benchmark.yardstick import peaks

READERS = sorted({m["name"] for m in spec.load_benchmark()["per_layer"]})
MS = 1_000_000  # ns


def _trace(device=(), spans=(), counts=None, units=4):
    return Trace(window=(0, 100 * MS), device=list(device), spans=list(spans), units=units,
                 counts=counts or {})


@pytest.mark.parametrize("name", READERS)
def test_silent_without_device_work(name):
    assert spec.load_metric_reader(name).read(_trace()) is None


def test_shares():
    k1 = KERNEL_NAMES["k1"]
    calls = [(6, 3072, 128, 4, 1)] * 2
    tr = _trace(device=[("gemm", 0, 10 * MS), ("x", 5 * MS, 20 * MS), (k1, 30 * MS, 30 * MS + 50_000),
                        (k1, 40 * MS, 40 * MS + 50_000)],
                spans=[("refresh", 60 * MS, 80 * MS)],
                counts={"kernel_work": {"k1": calls, "k2": []}, "flops": 67e9, "peak_flops": "float32",
                        "nodes": 1024})
    read = {n.split(".")[0]: spec.load_metric_reader(n).read(tr) for n in READERS}
    busy = 20 * MS + 2 * 50_000
    assert read["device_idle"] == pytest.approx(100.0 * (1 - busy / (100 * MS)))
    assert read["launches_per_step"] == read["launches_per_request"] == 1.0
    assert read["device_ms_per_step"] == read["device_ms_per_request"] == pytest.approx(busy / 1e6 / 4)
    assert read["refresh_share"] == pytest.approx(20.0)
    assert read["nodes_per_s"] == pytest.approx(1024 / 0.1)
    assert read["mfu"] == pytest.approx(100.0 * 67e9 / (0.1 * peaks.F32_FLOPS))
    # 4 units, each needing two calls' work, over 100 us of K1
    assert read["k1_roofline"] == pytest.approx(100.0 * 4 * 2 * peaks.k1_bound_s(*calls[0]) / 100e-6)
    assert read["k2_roofline"] is None
    # the longest gap, 40.05 to 100 ms, is named by the span open at its middle
    assert tr.idle_gaps()[:2] == [["refresh", pytest.approx(0.05995)],
                                  ["outside spans", pytest.approx(0.010)]]


@pytest.mark.parametrize("launches", [1, 2, 8])
def test_roofline_follows_the_needed_work_not_the_launches(launches):
    """The same K1 time split into any number of launches (a graph replay,
    a split kernel) reads the same share."""
    k1 = KERNEL_NAMES["k1"]
    work = {"k1": [(6, 3072, 128, 4, 1)] * 5, "k2": []}
    each = 400_000 // launches
    tr = _trace(device=[(k1, i * MS, i * MS + each) for i in range(launches)],
                counts={"kernel_work": work})
    want = 100.0 * 4 * 5 * peaks.k1_bound_s(*work["k1"][0]) / (launches * each / 1e9)
    assert spec.load_metric_reader("k1_roofline.pretrain").read(tr) == pytest.approx(want)


def test_device_trace_keeps_every_session(monkeypatch):
    """A long window is profiled in sessions that end at the driver's
    ticks, each after a device sync; the trace holds every session's
    device operations and neither host events nor annotations."""
    import types

    from benchmark.harness import trace as trace_mod

    sessions = []

    class Event:
        def __init__(self, name, dev, start_us, annotation=False):
            self._n, self._d, self._s, self._a = name, dev, start_us * 1000, annotation

        def name(self):
            return self._n

        def device_type(self):
            return self._d

        def start_ns(self):
            return self._s

        def duration_ns(self):
            return 1_000_000

        def is_user_annotation(self):
            return self._a

        def activity_type(self):
            return "gpu_user_annotation" if self._a else "kernel"

    def begin():
        sessions.append(len(sessions))
        return types.SimpleNamespace(k=sessions[-1])

    def end(prof):
        t = prof.k * 10_000  # us
        evs = [Event("gemm", "DeviceType.CUDA", t), Event("cudaLaunchKernel", "DeviceType.CPU", t),
               Event("Optimizer.step", "DeviceType.CUDA", t, annotation=True),
               Event("bench:window", "DeviceType.CUDA", t)]
        return types.SimpleNamespace(events=lambda: evs)

    monkeypatch.setattr(trace_mod, "_begin_device_session", begin)
    monkeypatch.setattr(trace_mod, "_end_device_session", end)
    syncs = []
    dt = trace_mod.DeviceTrace(lambda: syncs.append(1), session_s=0.0)

    def window(tick):
        for _ in range(3):
            tick()
        return 6

    tr = dt.run(window)
    assert len(sessions) == 4 and len(syncs) == 4
    assert [n for n, _, _ in tr.device] == ["gemm"] * 4
    assert tr.units == 6 and tr.window == (0, 31_000_000)
    assert spec.load_metric_reader("device_ms_per_step.pretrain").read(tr) == pytest.approx(4.0 / 6)
