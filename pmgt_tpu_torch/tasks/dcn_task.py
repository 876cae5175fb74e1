"""DCN workload: CTR prediction scored by AUC, optionally with PMGT item
embeddings in the item table (DCN-PMGT) (counterpart of
``pmgt_tpu/tasks/dcn_task.py``; reference pmgt/dcn/trainer.py).

The reference's protocol quirks are kept for metric parity: the valid and
test splits are scored pointwise on examples drawn once when the task is
built (``epoch_training_arrays`` with ``max_sample_items`` negatives per
pair, from a generator seeded ``seed * 23 + (split == "test")``); the loss
is the mean of per-chunk masked BCE means over chunks of
``test_batch_size`` examples; a NaN probability counts as 0 in the AUC
(dcn/trainer.py:200-209).
"""
from __future__ import annotations

import logging
from typing import Any, Dict

import numpy as np
import torch

from pmgt_tpu_torch.core.config import TrainArgs
from pmgt_tpu_torch.data.artifacts import load_artifacts, load_node_init_emb
from pmgt_tpu_torch.data.interactions import epoch_training_arrays
from pmgt_tpu_torch.metrics.ranking import roc_auc, stable_sigmoid
from pmgt_tpu_torch.models.dcn import DCN
from pmgt_tpu_torch.models.ncf import inject_item_embeddings
# init_run, test and train complete the workload contract the CLI calls
from pmgt_tpu_torch.tasks.interaction_base import (  # noqa: F401
    TOPK,
    InteractionTaskBase,
    init_run,
    masked_bce_sums,
    restore_eval_params,
    save_topk,
    seeded,
    split_interactions,
    test,
    train,
)
from pmgt_tpu_torch.tasks.pmgt_task import chunk_eval_inputs, reject_unported_options

logger = logging.getLogger("pmgt_tpu_torch")

EVAL_CHUNKS_PER_CALL = 64  # loss chunks scored per model call


class DCNTask(InteractionTaskBase):
    frozen_param = "item_embeddings"

    def __init__(self, args, artifacts, train_data, valid_data, test_data, device="cuda"):
        super().__init__(args, train_data, valid_data, test_data, device)
        self.artifacts = artifacts
        e = args.extra
        self.model = DCN(
            user_num=train_data.num_users,
            item_num=train_data.num_items,
            factor_num=e.get("factor_num", 32),
            deep_net_num_layers=e.get("deep_net_num_layers", 3),
            cross_net_num_layers=e.get("cross_net_num_layers", 3),
            emb_dropout=e.get("emb_dropout", 0.0),
            dropout=e.get("dropout", 0.0),
            use_layer_norm=e.get("use_layer_norm", False),
            layer_norm_eps=e.get("layer_norm_eps", 1e-12),
        )
        self.model.init_weights(torch.Generator().manual_seed(int(args.seed)))
        state = None
        if e.get("item_init_emb_path"):
            emb = load_node_init_emb(
                artifacts.item_classes, artifacts.node_classes,
                np.load(e["item_init_emb_path"]),
                normalize=e.get("normalize_item_init_emb", False), seed=args.seed,
            )
            state = inject_item_embeddings(self.model.state_dict(), emb, "item_embeddings")
            logger.info("injected PMGT item embeddings from %s", e["item_init_emb_path"])
        self.finish_init(state)
        # Evaluation examples are fixed when the task is built
        # (reference dcn/trainer.py:76-78).
        ms = e.get("max_sample_items", 5)
        self.eval_arrays = {
            split: epoch_training_arrays(
                data, ms, seeded(args.seed * 23 + (split == "test"), self.device))
            for split, data in (("valid", valid_data), ("test", test_data))
        }

    @torch.no_grad()
    def evaluate(self, split: str = "valid") -> Dict[str, float]:
        split = "valid" if split == "valid" else "test"
        users, items, labels = self.eval_arrays[split]
        if split not in self._eval_cache:
            arrays = chunk_eval_inputs(
                self.args.test_batch_size,
                (users.astype(np.int64), items.astype(np.int64),
                 labels.astype(np.float32), np.ones(len(users), np.float32)),
            )
            self._eval_cache[split] = [torch.as_tensor(a, device=self.device) for a in arrays]
        users_c, items_c, labels_c, mask_c = self._eval_cache[split]
        logits_all, sums, cnts = [], [], []
        for c0 in range(0, users_c.shape[0], EVAL_CHUNKS_PER_CALL):
            sl = slice(c0, c0 + EVAL_CHUNKS_PER_CALL)
            logits = self.model(users_c[sl].reshape(-1), items_c[sl].reshape(-1),
                                deterministic=True)
            s, c = masked_bce_sums(logits, labels_c[sl].reshape(-1), mask_c[sl].reshape(-1),
                                   users_c[sl].shape[0])
            logits_all.append(logits)
            sums.append(s)
            cnts.append(c)
        logits = torch.cat(logits_all)[: len(users)].cpu().numpy()
        sums, cnts = torch.cat(sums).cpu().numpy(), torch.cat(cnts).cpu().numpy()
        losses = (sums / np.maximum(cnts, 1))[cnts > 0]
        probs = stable_sigmoid(logits)
        probs[np.isnan(probs)] = 0  # reference NaN guard (dcn/trainer.py:201)
        prefix = "val" if split == "valid" else "test"
        return {f"{prefix}/auc": float(roc_auc(labels, probs)),
                f"{prefix}/loss": float(np.mean(losses))}


# ----------------------------------------------------------------------
# workload contract
# ----------------------------------------------------------------------

def check_args(args: TrainArgs) -> None:
    if args.early_criterion not in ("loss", "auc"):
        raise ValueError(f"invalid early_criterion {args.early_criterion}")
    if args.model_name != "DCN":
        raise ValueError(f"invalid model_name {args.model_name}")
    if args.mode in ("eval", "inference") and args.run_id is None:
        raise ValueError(f"mode {args.mode} requires --run-id")
    reject_unported_options(args)


def init_dataloader(args: TrainArgs, ctx: Dict[str, Any]) -> None:
    artifacts = ctx.get("artifacts") or load_artifacts(args.data_dir, args.dataset_name)
    ctx["artifacts"] = artifacts
    ctx.update(split_interactions(args, artifacts))
    logger.info("DCN data: %d train / %d valid / %d test pairs",
                len(ctx["train_data"].pairs), len(ctx["valid_data"].pairs),
                len(ctx["test_data"].pairs))


def init_model(args: TrainArgs, ctx: Dict[str, Any]) -> None:
    ctx["task"] = DCNTask(args, ctx["artifacts"], ctx["train_data"], ctx["valid_data"],
                          ctx["test_data"], device=ctx.get("device", "cuda"))


def inference(args: TrainArgs, ctx: Dict[str, Any], registry, run) -> Dict[str, np.ndarray]:
    """Full-catalogue top-k (user, item) CTR ranking from the best
    checkpoint, saved to ``args.inference_result_path`` if given."""
    task = ctx["task"]
    restore_eval_params(task, registry, run, args.run_id)
    out = task.export_topk(
        k=int(args.extra.get("topk", TOPK)),
        exclude_train=not args.extra.get("include_seen_items", False),
    )
    save_topk(args, out)
    return out
