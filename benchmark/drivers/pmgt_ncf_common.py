"""The PMGT_NCF task as the training and serving mixes build it: the
configuration's dataset, the interaction split, the task on the card and
the benchmark's weights loaded into it."""
from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import common
from benchmark.yardstick import tgdata


def split(cfg: dict, raw, seed: int):
    """(train, valid) pairs: the training pairs split as the command
    splits them (``valid_size`` of them to validation)."""
    return tgdata.train_test_split(raw.train_pairs, cfg["valid_size"],
                                   common.derive_seed(seed, common.PROGRAM))


def positives(train_pairs: np.ndarray) -> dict:
    """{user: set of training items}."""
    out: dict = {}
    for u, i in train_pairs.tolist():
        out.setdefault(u, set()).add(i)
    return out


def build(run) -> dict:
    from pmgt_tpu_torch.core.config import TrainArgs
    from pmgt_tpu_torch.data.interactions import InteractionData
    from pmgt_tpu_torch.tasks.pmgt_ncf_task import PMGTNCFTask

    cfg = run.cell.config
    raw = common.dataset(cfg, run.seed)
    train_pairs, valid_pairs = split(cfg, raw, run.seed)
    nu, ni = raw.num_users, raw.num_nodes
    args = TrainArgs(
        seed=common.derive_seed(run.seed, common.PROGRAM), model_name=cfg["model_name"],
        lr=cfg["lr"], decay=cfg["decay"], mp_enabled=cfg["precision"] == "bfloat16",
        train_batch_size=cfg["train_batch_size"], test_batch_size=cfg["test_batch_size"],
        valid_size=cfg["valid_size"], gradient_max_norm=cfg["gradient_max_norm"],
        num_epochs=cfg["num_epochs"],
        extra=dict(factor_num=cfg["factor_num"], num_layers=cfg["num_layers"],
                   num_ng=cfg["num_ng"], hidden_size=cfg["hidden_size"],
                   intermediate_size=cfg["intermediate_size"],
                   num_hidden_layers=cfg["num_hidden_layers"],
                   num_attention_heads=cfg["num_attention_heads"], beta=cfg["beta"],
                   max_ctx_neigh=cfg["max_ctx_neigh"],
                   hop_sampling_sizes=tuple(cfg["hop_sampling_sizes"]),
                   attention_impl=cfg["attention_impl"]))
    task = PMGTNCFTask(args, common.program_artifacts(raw),
                       InteractionData.build(train_pairs, nu, ni),
                       InteractionData.build(valid_pairs, nu, ni),
                       InteractionData.build(raw.test_pairs, nu, ni), device=run.device)
    shapes = common.pmgt_ncf_shapes(cfg, nu, ni)
    task.model.load_state_dict(common.make_weights(shapes, cfg, run.seed, run.device))
    return {"task": task, "raw": raw, "cfg": cfg, "train_pairs": train_pairs,
            "seed": run.seed, "device": run.device}


def reference_weights(state, dev):
    cfg, raw = state["cfg"], state["raw"]
    shapes = common.pmgt_ncf_shapes(cfg, raw.num_users, raw.num_nodes)
    return common.make_weights(shapes, cfg, state["seed"], dev)


def feats(state, dev):
    return [torch.as_tensor(t, device=dev) for t in state["raw"].feat_tables]
