"""``BENCHMARK.json`` and the files it names, found by name.

- a cell (``workloads`` entry) names its configuration and its traffic;
- a configuration is the JSON file its entry names (``configs/<name>.json``);
- a traffic mix is ``traffic/<traffic>.json``: a ``driver`` (a module of
  ``drivers/``) and that driver's parameters;
- a per-layer metric is read by ``metrics/<name>.py``, or, for a name
  with a suffix (``k1_roofline.serve``), by ``metrics/<prefix>.py``.

A new cell, configuration, mix or metric is new files and entries; no
file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json"), encoding="utf-8") as f:
        return json.load(f)


def _in_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(bench: dict, name: str, root: str = ROOT) -> Cell:
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(os.path.join(root, configs[w["config"]]["file"]), encoding="utf-8") as f:
        config = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic", w["traffic"] + ".json"), encoding="utf-8") as f:
        traffic = json.load(f)
    return Cell(
        name=name, chips=int(w["chips"]), config=config,
        traffic_name=w["traffic"], traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _in_cell(m, name)],
        per_layer=[m for m in bench["per_layer"] if _in_cell(m, name)],
    )


def _load(path: str, mod_name: str):
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(name: str):
    return _load(os.path.join(BENCH_DIR, "drivers", name + ".py"), f"bench_driver_{name}")


def metric_reader_path(name: str) -> str:
    exact = os.path.join(BENCH_DIR, "metrics", name + ".py")
    if os.path.exists(exact):
        return exact
    return os.path.join(BENCH_DIR, "metrics", name.split(".")[0] + ".py")


def load_metric_reader(name: str):
    return _load(metric_reader_path(name), "bench_metric_" + name.replace(".", "_").replace("-", "_"))


def read_per_layer(cell: Cell, trace) -> Dict[str, dict]:
    """Each per-layer metric of the cell that its reader finds something
    to read for: {name: {"value", "unit"}}."""
    out = {}
    for m in cell.per_layer:
        value = load_metric_reader(m["name"]).read(trace)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
