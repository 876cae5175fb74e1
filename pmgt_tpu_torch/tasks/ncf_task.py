"""NCF workload: GMF / MLP / NeuMF-end / NeuMF-pre, optionally with PMGT
item embeddings in the MLP item table (the paper's NeuMF-PMGT)
(counterpart of ``pmgt_tpu/tasks/ncf_task.py``; reference
pmgt/ncf/trainer.py).

NeuMF-pre fuses the ``best`` checkpoints of an earlier GMF run and an
earlier MLP run of the port's registry (``--gmf-run-id``, ``--mlp-run-id``);
``--item-init-emb-path`` takes the port's (or the JAX package's) exported
``[num_nodes, d]`` node embeddings, remapped to item ids by
``load_node_init_emb``. Evaluation ranks each user's candidate list
(``InteractionTaskBase.ranking_evaluate``, loss chunks of
``max(test_batch_size // 8, 1)`` users); inference writes the
full-catalogue top-k of every user to an ``.npz`` of
user_ids/item_ids/scores.
"""
from __future__ import annotations

import logging
from typing import Any, Dict

import numpy as np
import torch

from pmgt_tpu_torch.core.config import TrainArgs
from pmgt_tpu_torch.data.artifacts import load_artifacts, load_node_init_emb
from pmgt_tpu_torch.models.ncf import NCF, fuse_neumf_params, inject_item_embeddings
# init_run, test and train complete the workload contract the CLI calls
from pmgt_tpu_torch.tasks.interaction_base import (  # noqa: F401
    TOPK,
    InteractionTaskBase,
    init_run,
    restore_eval_params,
    save_topk,
    split_interactions,
    test,
    train,
)
from pmgt_tpu_torch.tasks.pmgt_task import reject_unported_options
from pmgt_tpu_torch.train.checkpoints import restore_checkpoint
from pmgt_tpu_torch.train.registry import RunRegistry

logger = logging.getLogger("pmgt_tpu_torch")

# (user, item) pairs scored per model call in evaluation (whole loss chunks)
EVAL_PAIRS_PER_CALL = 1 << 21


class NCFTask(InteractionTaskBase):
    frozen_param = "embed_item_MLP"

    def __init__(self, args, artifacts, train_data, valid_data, test_data, device="cuda"):
        super().__init__(args, train_data, valid_data, test_data, device)
        self.artifacts = artifacts
        e = args.extra
        self.model = NCF(
            user_num=train_data.num_users,
            item_num=train_data.num_items,
            factor_num=e.get("factor_num", 32),
            num_layers=e.get("num_layers", 3),
            emb_dropout=e.get("emb_dropout", 0.0),
            dropout=e.get("dropout", 0.0),
            use_layer_norm=e.get("use_layer_norm", False),
            layer_norm_eps=e.get("layer_norm_eps", 1e-12),
            model=args.model_name,
        )
        self.model.init_weights(torch.Generator().manual_seed(int(args.seed)))
        self.eval_chunk_users = max(args.test_batch_size // 8, 1)
        width = max(e.get("max_sample_items", 1000), 1)
        self.eval_chunks_per_call = max(EVAL_PAIRS_PER_CALL // (self.eval_chunk_users * width), 1)
        self.finish_init(self._pretrained_state())

    def _pretrained_state(self) -> Dict[str, torch.Tensor]:
        """NeuMF-pre fusion, then PMGT item-embedding injection
        (reference ncf/trainer.py:107-180)."""
        args, e = self.args, self.args.extra
        state = self.model.state_dict()
        if args.model_name == "NeuMF-pre":
            registry = RunRegistry(args.log_dir)

            def best_model(run_id):
                path = registry.get_ckpt_path(run_id, load_best=True)
                return restore_checkpoint(path)["state"]["model"]

            state = fuse_neumf_params(state, best_model(e["gmf_run_id"]),
                                      best_model(e["mlp_run_id"]), alpha=e.get("alpha", 0.5))
        if e.get("item_init_emb_path"):
            emb = load_node_init_emb(
                self.artifacts.item_classes, self.artifacts.node_classes,
                np.load(e["item_init_emb_path"]),
                normalize=e.get("normalize_item_init_emb", False), seed=args.seed,
            )
            state = inject_item_embeddings(state, emb, "embed_item_MLP")
            logger.info("injected PMGT item embeddings from %s", e["item_init_emb_path"])
        return state

    def evaluate(self, split: str = "valid") -> Dict[str, float]:
        return self.ranking_evaluate(split)


# ----------------------------------------------------------------------
# workload contract
# ----------------------------------------------------------------------

def check_args(args: TrainArgs) -> None:
    if args.early_criterion not in ("loss", "n20", "r20"):
        raise ValueError(f"invalid early_criterion {args.early_criterion}")
    if args.model_name not in ("MLP", "GMF", "NeuMF-end", "NeuMF-pre"):
        raise ValueError(f"invalid model_name {args.model_name}")
    if args.mode in ("eval", "inference") and args.run_id is None:
        raise ValueError(f"mode {args.mode} requires --run-id")
    if args.model_name == "NeuMF-pre" and not (
        args.extra.get("gmf_run_id") and args.extra.get("mlp_run_id")
    ):
        raise ValueError("NeuMF-pre requires --gmf-run-id and --mlp-run-id")
    if args.extra.get("item_init_emb_path") and args.model_name not in ("NeuMF-end", "MLP"):
        raise ValueError("item_init_emb_path requires model_name NeuMF-end or MLP")
    reject_unported_options(args)


def init_dataloader(args: TrainArgs, ctx: Dict[str, Any]) -> None:
    artifacts = ctx.get("artifacts") or load_artifacts(args.data_dir, args.dataset_name)
    ctx["artifacts"] = artifacts
    ctx.update(split_interactions(args, artifacts))
    logger.info(
        "NCF data: %d train / %d valid / %d test pairs, %d users, %d items",
        len(ctx["train_data"].pairs), len(ctx["valid_data"].pairs),
        len(ctx["test_data"].pairs), artifacts.num_users, artifacts.num_items,
    )


def init_model(args: TrainArgs, ctx: Dict[str, Any]) -> None:
    ctx["task"] = NCFTask(args, ctx["artifacts"], ctx["train_data"], ctx["valid_data"],
                          ctx["test_data"], device=ctx.get("device", "cuda"))


def inference(args: TrainArgs, ctx: Dict[str, Any], registry, run) -> Dict[str, np.ndarray]:
    """Full-catalogue top-k of every user from the best checkpoint, saved
    to ``args.inference_result_path`` (``.npz``) if given."""
    task = ctx["task"]
    restore_eval_params(task, registry, run, args.run_id)
    out = task.export_topk(
        k=int(args.extra.get("topk", TOPK)),
        exclude_train=not args.extra.get("include_seen_items", False),
    )
    save_topk(args, out)
    return out
