"""BENCHMARK.json against the contract's shape, every file it names found
by name, and a cell added as new files picked up with no file edited."""
from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from benchmark.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_shape(bench):
    assert set(bench) == TOP_KEYS
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    for entry in bench["configs"] + bench["workloads"] + bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and len(c["why"]) <= 200
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert {m["name"] for m in bench["end_to_end"]} >= {"setup_s"}
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in spec.load_benchmark()["workloads"]])
def test_every_cell_loads(bench, cell):
    c = spec.find_cell(bench, cell)
    driver = spec.load_driver(c.traffic["driver"])
    for fn in ("setup", "window", "traced", "release", "check", "control"):
        assert callable(getattr(driver, fn))
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer, "a cell reports at least one per-layer metric"
    for m in c.per_layer:
        assert m["moves"] in e2e
        assert callable(spec.load_metric_reader(m["name"]).read)


def test_each_per_layer_metric_moves_an_end_to_end_metric_of_its_cells(bench):
    """Every cell a per-layer metric is read in reports the end-to-end
    metric the per-layer one should move."""
    cells = [w["name"] for w in bench["workloads"]]
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        mine = m.get("workloads", cells)
        assert mine and set(mine) <= set(cells), m["name"]
        moved = e2e[m["moves"]]
        assert all(spec._in_cell(moved, c) for c in mine), (m["name"], m["moves"])


@pytest.mark.parametrize("cell,metric", [("pmgt-tg.pretrain", "device_ms_per_step.pretrain"),
                                         ("pmgt_ncf-tg.serve", "device_ms_per_request.serve")])
def test_host_bound_cells_are_held_on_the_cards_time(bench, cell, metric):
    """Cells whose host rate swings with the shared host are held on the
    card's busy time a unit, read from the device trace; the host rate is
    a per-layer metric there."""
    c = spec.find_cell(bench, cell)
    assert {m["name"]: m["source"] for m in c.end_to_end} == {metric: "device_trace",
                                                              "setup_s": "host_clock"}
    rates = [m for m in c.per_layer if m["source"] == "host_clock" and m["unit"].endswith("/s")]
    assert rates and all(m["moves"] == metric for m in rates)


def test_a_new_cell_is_files_only(tmp_path):
    """A new mix, a new configuration and a new cell of them: data files
    and entries, found with nothing else edited."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(spec.ROOT, "benchmark"), root / "benchmark")
    bench = spec.load_benchmark()
    (root / "benchmark" / "traffic" / "serve-8user.json").write_text(json.dumps(
        {"driver": "pmgt_ncf_serve", "users_per_request": 8, "users": "uniform", "topk": 100,
         "item_chunk": 2048, "trace_requests": 20, "rate_metric": "online_users_per_s"}))
    cfg = json.loads((root / "benchmark" / "configs" / "pmgt_ncf-tg.json").read_text())
    cfg["num_hidden_layers"] = 3
    (root / "benchmark" / "configs" / "pmgt_ncf-tg-l3.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "pmgt_ncf-tg-l3", "source": "s", "reduced": ["num_hidden_layers"],
                             "file": "benchmark/configs/pmgt_ncf-tg-l3.json", "why": "w"})
    bench["workloads"].append({"name": "pmgt_ncf-tg-l3.serve-8user", "config": "pmgt_ncf-tg-l3",
                               "traffic": "serve-8user", "chips": 1, "why": "w"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "pmgt_ncf-tg.serve-1user" in m.get("workloads", ()):
            m["workloads"].append("pmgt_ncf-tg-l3.serve-8user")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.find_cell(spec.load_benchmark(str(root)), "pmgt_ncf-tg-l3.serve-8user", str(root))
    assert c.config["num_hidden_layers"] == 3 and c.traffic["users_per_request"] == 8
    assert {m["name"] for m in c.end_to_end} == {"serve_p95_ms", "setup_s"}
    assert {m["name"] for m in c.per_layer} >= {"mfu.online", "k1_roofline.online",
                                                "users_per_s.online"}
    assert spec.metric_reader_path("k1_roofline.serve").endswith("k1_roofline.py")


def test_configs_match_their_sources():
    """What the cells run: PMGTConfig's defaults and the published
    PMGT_NCF script's flags, nothing reduced."""
    pre = json.load(open(os.path.join(spec.ROOT, "benchmark/configs/pmgt-tg.json")))
    ncf = json.load(open(os.path.join(spec.ROOT, "benchmark/configs/pmgt_ncf-tg.json")))
    for cfg in (pre, ncf):
        assert cfg["reduced"] == [] and cfg["dataset"] == "TG"
        assert (cfg["hidden_size"], cfg["num_hidden_layers"], cfg["intermediate_size"]) == (128, 5, 128)
        assert cfg["feat_dims"] == [1536, 768] and cfg["hop_sampling_sizes"] == [16, 8, 4]
    assert pre["precision"] == "float32" and pre["train_batch_size"] == 256
    assert (ncf["precision"], ncf["factor_num"], ncf["num_layers"], ncf["train_batch_size"],
            ncf["lr"], ncf["gradient_max_norm"]) == ("bfloat16", 64, 2, 128, 1e-4, 5.0)
