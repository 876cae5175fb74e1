"""Tiny cells on the CPU: the configurations' files with a small dataset
and narrow widths, driven through a driver's set-up, window and check the
way ``run.py`` drives them, without its look for a card."""
from __future__ import annotations

import copy

import torch

from benchmark.harness import spec

TINY_DATA = {"num_nodes": 150, "num_users": 120, "num_edges": 500, "num_interactions": 900}
TINY_SIZES = {"feat_dims": [48, 24], "hidden_size": 32, "intermediate_size": 32,
              "num_hidden_layers": 2, "hop_sampling_sizes": [8, 4, 2], "dataset": TINY_DATA}
TINY_TRAFFIC = {"pretrain": {"train_batch_size": 16},
                "train": {"train_batch_size": 32},
                "serve": {"item_chunk": 64},
                "serve-1user": {"item_chunk": 150}}


class Run:
    def __init__(self, cell, seed, device):
        self.cell, self.seed, self.device = cell, seed, device


def tiny_cell(name: str) -> spec.Cell:
    cell = spec.find_cell(spec.load_benchmark(), name)
    cfg = copy.deepcopy(cell.config)
    cfg.update(TINY_SIZES)
    traffic = copy.deepcopy(cell.traffic)
    extra = TINY_TRAFFIC.get(cell.traffic_name, {})
    for k, v in extra.items():
        (cfg if k in cfg else traffic)[k] = v
    if "factor_num" in cfg:
        cfg["factor_num"] = 8
    if "trace_epochs" in traffic:
        traffic["trace_epochs"] = 1
    if "trace_steps" in traffic:
        traffic["trace_steps"] = 3
    if "trace_requests" in traffic:
        traffic["trace_requests"] = 2
    cell.config, cell.traffic = cfg, traffic
    return cell


def drive(name: str, seed: int = 12345, seconds: float = 0.5, trace: bool = False,
          after_setup=None):
    """(result, checks, state) of a tiny run of cell ``name`` on the CPU;
    ``after_setup()``, where given, breaks the program once set-up is
    done, so that only the window and what follows it run broken."""
    from benchmark.harness.trace import traced

    torch.manual_seed(0)
    cell = tiny_cell(name)
    driver = spec.load_driver(cell.traffic["driver"])
    run = Run(cell, seed, torch.device("cpu"))
    state = driver.setup(run)
    if after_setup is not None:
        after_setup()
    if trace:
        tr = traced(driver.traced(state, cell.traffic), False)
        result = {"metrics": spec.read_per_layer(cell, tr), "trace": tr}
    else:
        result = driver.window(state, seconds)
    driver.tail(state)
    driver.release(state)
    return result, driver.check(state), state

