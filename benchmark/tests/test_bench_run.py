"""``run.py`` refuses to run without a card and outside a full checkout."""
from __future__ import annotations

import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import run
from benchmark.harness import spec

ARGS = ["--workload", "pmgt-tg.pretrain", "--seed", "2147483901", "--seconds", "1", "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS], cwd=cwd, capture_output=True,
                          text=True, timeout=120, env=env)


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(spec.ROOT, env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_refuses_without_the_program(tmp_path):
    shutil.copytree(os.path.join(spec.ROOT, "benchmark"), tmp_path / "benchmark")
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    out = _run(str(tmp_path), dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_forbidden_names_are_whole():
    sys.modules.setdefault("pmgt_tpu_torch", sys.modules.get("pmgt_tpu_torch"))
    assert "pmgt_tpu_torch" not in run.forbidden_modules()


def test_bad_arguments():
    with pytest.raises(SystemExit):
        run.parse(["--workload", "x"])


class _Driver:
    def __init__(self, attempted):
        self.attempted = attempted

    def window(self, state, seconds, tick=None):
        for _ in range(self.attempted):
            if tick is not None:
                tick()
        return {"attempted": self.attempted, "failed": 0, "metrics": {"host_rate": 1.0}}


def test_device_trace_metrics_come_from_the_profiled_window(monkeypatch):
    """An end-to-end metric whose source is the device trace is read by its
    reader from the whole window, profiled, with the driver ticking
    between units; a cell with such a metric and no card raises."""
    from benchmark.harness import trace as trace_mod

    device = [("k", 0, 3_000_000), ("k", 10_000_000, 11_000_000)]
    seen = {"ticks": 0}

    class FakeTrace:
        def __init__(self, sync):
            seen["made"] = True

        def run(self, window):
            units = window(lambda: seen.__setitem__("ticks", seen["ticks"] + 1))
            return trace_mod.Trace(window=(0, 11_000_000), device=device, spans=[], units=units)

    monkeypatch.setattr(trace_mod, "DeviceTrace", FakeTrace)
    cuda = torch.device("cuda", 0)
    bench = spec.load_benchmark()
    timed = {c: m["name"] for m in bench["end_to_end"] if m["source"] == "device_trace"
             for c in m["workloads"]}
    assert set(timed) == {"pmgt-tg.pretrain", "pmgt_ncf-tg.serve"}
    for name, metric in timed.items():
        cell = spec.find_cell(bench, name)
        seen.update(ticks=0)
        res = run.timed_window(cell, _Driver(4), {}, 1.0, cuda)
        assert seen["ticks"] == 4
        assert res["metrics"][metric] == pytest.approx(4.0 / 4)
        with pytest.raises(RuntimeError):
            run.timed_window(cell, _Driver(0), {}, 1.0, cuda)
        with pytest.raises(RuntimeError):
            run.timed_window(cell, _Driver(4), {}, 1.0, torch.device("cpu"))


@pytest.mark.parametrize("name", ["pmgt_ncf-tg.serve-1user", "pmgt_ncf-tg.train"])
def test_a_cell_timed_on_the_host_runs_unprofiled(monkeypatch, name):
    """A cell with no end-to-end metric from the device trace runs its
    window without the profiler, on a machine with or without a card."""
    from benchmark.harness import trace as trace_mod

    def no_trace(sync):
        raise AssertionError("the window was profiled")

    monkeypatch.setattr(trace_mod, "DeviceTrace", no_trace)
    cell = spec.find_cell(spec.load_benchmark(), name)
    for device in (torch.device("cuda", 0), torch.device("cpu")):
        assert run.timed_window(cell, _Driver(4), {}, 1.0, device)["metrics"] == {"host_rate": 1.0}
