"""PMGT_NCF workload: NCF with a PMGT item tower, end to end (counterpart
of ``pmgt_tpu/tasks/pmgt_ncf_task.py``).

An item is encoded over its sampled neighbourhood: item id → node id
(``item_to_node_map``) → that node's row of a context table drawn for the
whole graph (``sample_all_contexts``). Training draws one table per epoch
(generator seeded ``seed * 55_001 + epoch``) and keys it on the epoch
together with the epoch's examples, so no step reads a stale epoch's
contexts or negatives (the JAX task gates both on ``is None``).
Evaluation and serving use one fixed draw (seeded from ``(seed,
0xE7A1)``), so their results are a function of the parameters alone,
whatever the training schedule.

Evaluation is the NCF ranking protocol in chunks of ``max(test_batch_size
// 64, 1)`` users, one encoder call over the chunk's candidates each;
serving encodes each catalogue item once a call of ``serve_users`` (the
scorer's item stage), then scores tiles of ``serve_user_batch`` users ×
``serve_item_chunk`` items (64 × 1024 by default) through the towers. The
encoder runs the hand-written dual-attention kernels on the card (K1
forward, five launches a call; K2 backward, five a training step) and
their plain versions on the CPU. Unlike the JAX task, gradients honour ``accumulation_step``.
``mp_enabled`` runs the encoder in bf16 (``PMGTConfig.dtype``) with the
feature tables stored in bf16 unless ``feat_tables_dtype`` says otherwise,
as in the PMGT task, and so do ``--shard-feat-tables`` and
``--shard-graph-tables`` (the rank's row blocks; the context draws are the
replicated draw's).
"""
from __future__ import annotations

import logging
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from pmgt_tpu_torch.core.config import (
    PMGTConfig,
    SamplingConfig,
    TrainArgs,
    resolve_fusion_strategy,
)
from pmgt_tpu_torch.core.mesh import place_graph
from pmgt_tpu_torch.core.quant import prepare_feat_tables
from pmgt_tpu_torch.core.tracing import span
from pmgt_tpu_torch.data.artifacts import load_artifacts
from pmgt_tpu_torch.graph.container import NUM_SPECIAL_NODES
from pmgt_tpu_torch.models.pmgt_ncf import PMGT_NCF
from pmgt_tpu_torch.sampling.pairs import sample_all_contexts
# init_run, test and train complete the workload contract the CLI calls
from pmgt_tpu_torch.tasks.interaction_base import (  # noqa: F401
    TOPK,
    InteractionTaskBase,
    Scorer,
    init_run,
    restore_eval_params,
    save_topk,
    seeded,
    split_interactions,
    test,
    train,
)
from pmgt_tpu_torch.tasks.pmgt_task import CTX_BYTES, feat_tables_dtype, refresh_budget

logger = logging.getLogger("pmgt_tpu_torch")

Ctx = Tuple[torch.Tensor, torch.Tensor]  # (ctx_ids [N_total, S], ctx_mask [N_total, S])


def item_to_node_map(artifacts) -> np.ndarray:
    """item id → node id: item + 2 when the item and node encoders
    coincide (reference pmgt_ncf/datasets.py:62-67), else by label class,
    with items absent from the graph on node 0 (<pad>: they encode as a
    bare sequence)."""
    ni = artifacts.num_items
    items, nodes = artifacts.item_classes, artifacts.node_classes
    if items is None or nodes is None or (
        len(items) == len(nodes) and (np.asarray(items) == np.asarray(nodes)).all()
    ):
        return np.arange(NUM_SPECIAL_NODES, ni + NUM_SPECIAL_NODES, dtype=np.int32)
    node_idx = {label: i + NUM_SPECIAL_NODES for i, label in enumerate(np.asarray(nodes).tolist())}
    return np.asarray([node_idx.get(label, 0) for label in np.asarray(items).tolist()], np.int32)


def eval_ctx_seed(seed: int) -> int:
    """The evaluation draw's seed: a hash of (seed, 0xE7A1), distinct from
    every training epoch's ``seed * 55_001 + epoch``."""
    return int(np.random.SeedSequence([int(seed) % 2**32, 0xE7A1]).generate_state(1)[0])


class PMGTNCFTask(InteractionTaskBase):
    def __init__(self, args, artifacts, train_data, valid_data, test_data, device="cuda",
                 trial=None):
        super().__init__(args, train_data, valid_data, test_data, device, trial)
        self.artifacts = artifacts
        e = args.extra
        self.config = PMGTConfig(
            hidden_size=e.get("hidden_size", 128),
            feat_hidden_sizes=tuple(int(t.shape[-1]) for t in artifacts.feat_init_embs),
            intermediate_size=e.get("intermediate_size", 128),
            num_hidden_layers=e.get("num_hidden_layers", 5),
            num_attention_heads=e.get("num_attention_heads", 1),
            beta=e.get("beta", 0.5),
            # The kernel route; on CPU tensors it runs the plain version.
            attention_impl=e.get("attention_impl") or "pallas",
            dtype="bfloat16" if args.mp_enabled else "float32",
            fusion_strategy=resolve_fusion_strategy(e.get("fusion_strategy"), artifacts.num_nodes),
        )
        self.sampling = SamplingConfig(
            max_ctx_neigh=e.get("max_ctx_neigh", 5),
            hop_sampling_sizes=tuple(e.get("hop_sampling_sizes", (16, 8, 4))),
            num_total=artifacts.graph.num_total,
        )
        self.model = PMGT_NCF(
            user_num=train_data.num_users,
            item_num=train_data.num_items,
            config=self.config,
            factor_num=e.get("factor_num", 32),
            num_layers=e.get("num_layers", 3),
            emb_dropout=e.get("emb_dropout", 0.0),
            dropout=e.get("dropout", 0.0),
            model=args.model_name,
        )
        self.model.init_weights(torch.Generator().manual_seed(int(args.seed)))
        self.graph = place_graph(self.mesh, artifacts.graph, bool(e.get("shard_graph_tables")),
                                 self.device)
        self.feat_tables = prepare_feat_tables(
            artifacts.feat_init_embs, feat_tables_dtype(args), self.device,
            shard=self.mesh if e.get("shard_feat_tables") else None)
        # Resident draws a node: the epoch's contexts, the evaluation
        # contexts and the draw in progress (the old epoch's table lives
        # until the new one is drawn).
        self.refresh = refresh_budget(
            self.mesh, self.device, self.graph, self.sampling, self.feat_tables,
            self.sampling.num_total * 3 * CTX_BYTES * self.sampling.seq_len)
        self.item_to_node = torch.as_tensor(item_to_node_map(artifacts), dtype=torch.int64,
                                            device=self.device)
        self.eval_chunk_users = max(args.test_batch_size // 64, 1)
        self.finish_init()
        self._train_ctx: Optional[Ctx] = None
        self._train_ctx_epoch: Optional[int] = None
        self._eval_ctx: Optional[Ctx] = None

    def _draw_ctx(self, seed: int) -> Ctx:
        return sample_all_contexts(self.graph, self.sampling, self.sampling.num_total,
                                   seeded(seed, self.device), chunk=self.refresh["chunk"])

    def on_epoch_start(self, epoch: int) -> None:
        """The epoch's examples and context table (no-op if they are this
        epoch's), in a ``refresh`` span."""
        if self._epoch_arrays_epoch == epoch and self._train_ctx_epoch == epoch:
            return
        with span("refresh", nodes=self.sampling.num_total):
            super().on_epoch_start(epoch)
            if self._train_ctx_epoch != epoch:
                self._train_ctx = self._draw_ctx(self.args.seed * 55_001 + epoch)
                self._train_ctx_epoch = epoch

    def eval_ctx(self) -> Ctx:
        """The fixed evaluation/serving context draw (drawn on first use)."""
        if self._eval_ctx is None:
            self._eval_ctx = self._draw_ctx(eval_ctx_seed(self.args.seed))
        return self._eval_ctx

    def _sequences(self, items: torch.Tensor, ctx: Ctx):
        nodes = self.item_to_node[items]
        return ctx[0][nodes], ctx[1][nodes]

    def train_logits(self, users, items, generator) -> torch.Tensor:
        seqs, mask = self._sequences(items, self._train_ctx)
        return self.model(self.feat_tables, users, seqs, mask, item=items,
                          deterministic=False, generator=generator)

    def scorer(self) -> Scorer:
        """The item stage: items through the encoder over the evaluation
        contexts → their CLS rows, in the encoder's dtype; the pair stage:
        the towers. The table projections are made once per scorer."""
        ctx = self.eval_ctx()
        proj = (self.model.project_tables(self.feat_tables)
                if self.config.fusion_strategy == "project_tables" else None)

        def items(ids):
            seqs, mask = self._sequences(ids, ctx)
            return self.model.encode_items(self.feat_tables, seqs, mask, deterministic=True,
                                           proj_tables=proj)

        def pairs(users, ids, rows):
            return self.model.towers(users, rows, ids, deterministic=True)

        return Scorer(pairs, items)

    def evaluate(self, split: str = "valid") -> Dict[str, float]:
        return self.ranking_evaluate(split)


# ----------------------------------------------------------------------
# workload contract
# ----------------------------------------------------------------------

def check_args(args: TrainArgs) -> None:
    if args.early_criterion not in ("loss", "n20", "r20"):
        raise ValueError(f"invalid early_criterion {args.early_criterion}")
    if args.model_name not in ("MLP", "NeuMF-end"):
        raise ValueError(f"invalid model_name {args.model_name}")
    if args.mode in ("eval", "inference") and args.run_id is None:
        raise ValueError(f"mode {args.mode} requires --run-id")


def init_dataloader(args: TrainArgs, ctx: Dict[str, Any]) -> None:
    artifacts = ctx.get("artifacts") or load_artifacts(args.data_dir, args.dataset_name)
    ctx["artifacts"] = artifacts
    ctx.update(split_interactions(args, artifacts))


def init_model(args: TrainArgs, ctx: Dict[str, Any], trial=None) -> None:
    ctx["task"] = PMGTNCFTask(args, ctx["artifacts"], ctx["train_data"], ctx["valid_data"],
                              ctx["test_data"], device=ctx.get("device", "cuda"), trial=trial)


def inference(args: TrainArgs, ctx: Dict[str, Any], registry, run) -> Dict[str, np.ndarray]:
    """Full-catalogue top-k of every user: each batch of
    ``serve_user_batch`` users encodes the catalogue once over the
    evaluation contexts, then scores tiles of ``serve_user_batch`` ×
    ``serve_item_chunk`` (user, item) pairs through the towers."""
    task = ctx["task"]
    restore_eval_params(task, registry, run, args.run_id)
    out = task.export_topk(
        k=int(args.extra.get("topk", TOPK)),
        user_batch=int(args.extra.get("serve_user_batch", 64)),
        item_chunk=int(args.extra.get("serve_item_chunk", 1024)),
        exclude_train=not args.extra.get("include_seen_items", False),
    )
    save_topk(args, out, task.mesh)
    return out
