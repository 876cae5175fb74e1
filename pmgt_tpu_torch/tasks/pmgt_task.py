"""PMGT pre-training workload: training steps, validation pair-AUC,
per-node embedding export and the workload contract the CLI drives
(counterpart of ``pmgt_tpu/tasks/pmgt_task.py``).

Per phase (``valid``, ``test``, ``inference``) the task draws ONE context
per node for the whole graph (``sample_all_contexts``) and, for the
evaluation splits, one eval pair table (``sample_all_pairs``), from a
generator seeded by the fixed per-phase seed ``_phase_seed``. Evaluation
and export are then pure gathers plus encoder passes over chunks of
``test_batch_size`` targets, so their metrics are a function of the
parameters alone.

Training runs either of the JAX package's modes. Cached (the default):
at each epoch start (``on_epoch_start``) one context per node and one
training pair table (P = ``max_total_samples``) are drawn into a single
evicting slot, and a step gathers its batch from them. Per-step sampling
(``ctx_cache=False``, ``--no-ctx-cache``): each step draws a fresh context
for every target and every pair node and fresh pairs
(``make_pretrain_batch``) from three generators seeded from the step's
seed; evaluation and export keep their fixed per-phase draws in both
modes. An epoch walks the shuffled schedule (``_epoch_schedule``) in full
batches; each step gets its own generator, seeded ``(seed * 7_919 + step)
% 2**32``, which draws the NFR corruption and then the dropout masks
(``models/pmgt.py``) for each micro-batch in turn. Gradients are the mean
over ``accumulation_step`` micro-batches; AdamW, the schedule and the clip
come from ``train/optim.py``. ``train_epoch`` returns the per-step losses
as a device tensor and never waits on the device.

``mp_enabled`` is the bf16 compute policy (``PMGTConfig.dtype =
"bfloat16"``, f32 parameters); the frozen feature tables are stored as
``feat_tables_dtype`` says, bf16 by default under the policy, else f32
(``core/quant.prepare_feat_tables``; int8 is per-row quantized).

The engine (``train/engine.fit``) checkpoints ``state_dict()`` (model,
optimizer, step count) and on resume calls ``on_resume(global_step,
start_epoch)``, so a resumed run continues the per-step seeds and the
schedule where it stopped.

Data parallelism (``--num-devices``, ``core/mesh``): the task runs in
every rank of the group with the same seeds, so every rank draws the same
schedule, contexts and pair tables. Micro-batch j of a step is the global
slice ``targets[j·m:(j+1)·m]`` (m = batch / accumulation) and rank r takes
its r-th contiguous 1/N; the model draws the global micro-batch's random
tensors and keeps the rank's lanes, and divides by global denominators
(``models/pmgt.py``); the gradients are summed over the ranks in one
all-reduce before the clip and the update, so every rank applies the same
update to the same parameters (broadcast from rank 0 at the start).
Evaluation and export chunks are padded to a multiple of the world size,
each rank encodes its share of a chunk and the outputs are gathered to
every rank. ``--shard-feat-tables`` and ``--shard-graph-tables`` keep each
rank's row block of the feature tables and of the per-node graph tables
(``core/mesh.place_graph``); the contexts drawn over sharded graph tables
are the replicated draw's, bit for bit, and ``SamplingConfig.num_total``
stays the true node count.

Torch generators give other streams than JAX keys: the seeds are the same
integers and the distributions are the same, the draws are not.
"""
from __future__ import annotations

import logging
import os
from typing import Any, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from pmgt_tpu_torch.core.config import (
    PMGTConfig,
    SamplingConfig,
    TrainArgs,
    resolve_fusion_strategy,
)
from pmgt_tpu_torch.core.device import resolve_device
from pmgt_tpu_torch.core.mesh import (
    all_reduce,
    all_reduce_grads,
    barrier,
    gather_chunks,
    lane_draws,
    local_slice,
    make_mesh,
    place_graph,
    rank_chunks,
    replicate,
)
from pmgt_tpu_torch.core.quant import prepare_feat_tables
from pmgt_tpu_torch.data.artifacts import DatasetArtifacts, load_artifacts
from pmgt_tpu_torch.data.split import train_test_split
from pmgt_tpu_torch.graph.container import NUM_SPECIAL_NODES
from pmgt_tpu_torch.metrics.ranking import roc_auc, stable_sigmoid
from pmgt_tpu_torch.models.pmgt import PMGTForPreTraining
from pmgt_tpu_torch.sampling.pairs import (
    make_pretrain_batch,
    make_pretrain_batch_cached,
    sample_all_contexts,
    sample_all_pairs,
)
from pmgt_tpu_torch.train import engine
from pmgt_tpu_torch.train.checkpoints import restore_checkpoint
from pmgt_tpu_torch.train.optim import make_optimizer
from pmgt_tpu_torch.train.registry import RunRegistry, locate_eval_ckpt

logger = logging.getLogger("pmgt_tpu_torch")

# (ctx_ids [N_total, S], ctx_mask [N_total, S], pairs or None), where
# pairs = (pair_nodes, labels, pair_valid), each [N_total, P].
PhaseCtx = Tuple[torch.Tensor, torch.Tensor, Optional[Tuple[torch.Tensor, ...]]]


class PMGTTask:
    """PMGT task: ``train_epoch`` / ``train_step``, ``evaluate`` and
    ``export_embeddings``.

    ``device`` defaults to ``"cuda"`` and raises when no GPU is present;
    pass ``device="cpu"`` to run the plain PyTorch versions. Parameters
    are initialised from ``args.seed`` (normal(initializer_range) kernels
    and embeddings, zero biases, unit LayerNorm scales, as flax does);
    load trained weights with ``task.model.load_state_dict``.
    """

    def __init__(
        self,
        args: TrainArgs,
        artifacts: DatasetArtifacts,
        train_nodes: np.ndarray,
        valid_nodes: np.ndarray,
        device: Union[str, torch.device] = "cuda",
        trial=None,
    ):
        self.device = resolve_device(device)
        self.args = args
        self.trial = trial  # an hp-tuning trial, with pruning enabled
        self.artifacts = artifacts
        self.train_nodes = np.asarray(train_nodes, np.int64)
        self.valid_nodes = np.asarray(valid_nodes, np.int64)
        extra = args.extra
        self.mesh = make_mesh(args.num_devices, self.device)
        n_dev = self.mesh.size
        if args.train_batch_size % (n_dev * args.accumulation_step):
            raise ValueError(
                f"train_batch_size {args.train_batch_size} must be divisible "
                f"by num_devices*accumulation ({n_dev}*{args.accumulation_step})"
            )
        self.use_ctx_cache = bool(extra.get("ctx_cache", True))

        feat_dims = tuple(int(e.shape[-1]) for e in artifacts.feat_init_embs)
        self.config = PMGTConfig(
            hidden_size=extra.get("hidden_size", 128),
            feat_hidden_sizes=feat_dims,
            intermediate_size=extra.get("intermediate_size", 128),
            num_hidden_layers=extra.get("num_hidden_layers", 5),
            num_attention_heads=extra.get("num_attention_heads", 1),
            beta=extra.get("beta", 0.5),
            position_embedding_type=extra.get(
                "position_embedding_type", "absolute"
            ),
            # The kernel route; on CPU tensors it runs the plain version.
            attention_impl=extra.get("attention_impl") or "pallas",
            dtype="bfloat16" if args.mp_enabled else "float32",
            gradient_checkpointing=extra.get("gradient_checkpointing", False),
            fusion_strategy=resolve_fusion_strategy(
                extra.get("fusion_strategy"), artifacts.num_nodes
            ),
        )
        self.sampling = SamplingConfig(
            max_ctx_neigh=extra.get("max_ctx_neigh", 5),
            hop_sampling_sizes=tuple(extra.get("hop_sampling_sizes", (16, 8, 4))),
            max_total_samples=extra.get("max_total_samples", 10),
            min_neg_samples=extra.get("min_neg_samples", 5),
            num_total=artifacts.graph.num_total,
        )
        self.model = PMGTForPreTraining(
            self.config,
            artifacts.num_nodes,
            random_node_ratio=extra.get("random_node_ratio", 0.02),
            mask_node_ratio=extra.get("mask_node_ratio", 0.16),
        )
        self.model.init_weights(torch.Generator().manual_seed(int(args.seed)))
        replicate(self.mesh, self.model.to(self.device).train())
        steps_per_epoch = max(len(self.train_nodes) // args.train_batch_size, 1)
        self.optimizer = make_optimizer(
            self.model,
            optim=args.optim,
            lr=args.lr,
            decay=args.decay,
            scheduler_type=args.scheduler_type,
            total_steps=steps_per_epoch * args.num_epochs,
            warmup_ratio=args.scheduler_warmup,
            gradient_max_norm=args.gradient_max_norm,
        )

        self.graph = place_graph(self.mesh, artifacts.graph,
                                 bool(extra.get("shard_graph_tables")), self.device)
        self.feat_tables = prepare_feat_tables(
            artifacts.feat_init_embs, feat_tables_dtype(args), self.device,
            shard=self.mesh if extra.get("shard_feat_tables") else None,
        )
        # One fixed draw per phase tag, kept for the task's lifetime.
        self._phase_ctx_cache: Dict[Tuple, PhaseCtx] = {}
        # The training draw: one evicting slot, retagged each epoch.
        self._train_ctx: Optional[PhaseCtx] = None
        self._train_ctx_tag: Optional[Tuple] = None
        self._step_count = 0

    # ------------------------------------------------------------------
    def _phase_seed(self, tag) -> int:
        """Deterministic per-phase cache seed (the JAX package's formula,
        reduced to uint32 as its np.uint32 cast does)."""
        phase_id = {"train": 1, "valid": 2, "test": 3, "inference": 4}[tag[0]]
        step = int(tag[1]) if len(tag) > 1 else 0
        return (self.args.seed * 104_729 + phase_id * 2_000_003 + step) % 2**32

    def _draw_ctx(self, tag) -> PhaseCtx:
        """Contexts for every node, then the phase's pair table (training
        pairs for ``("train", epoch)``, eval pairs for the eval splits,
        none for export), drawn in that order from one generator seeded
        per phase."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self._phase_seed(tag))
        n_total = self.sampling.num_total
        ctx_ids, ctx_mask = sample_all_contexts(
            self.graph, self.sampling, n_total, gen
        )
        if tag[0] == "inference":  # export never consumes pairs
            pairs = None
        else:
            pairs = sample_all_pairs(
                self.graph, self.sampling, n_total,
                is_training=tag[0] == "train", generator=gen,
            )
        return ctx_ids, ctx_mask, pairs

    def _get_ctx(self, tag) -> PhaseCtx:
        """The phase's cached draw (drawn on first use). ``("train",
        epoch)`` lives in one evicting slot; the eval and export draws are
        kept apart, so a training retag never evicts them."""
        if tag[0] == "train":
            if self._train_ctx_tag != tag:
                self._train_ctx = self._draw_ctx(tag)
                self._train_ctx_tag = tag
            return self._train_ctx
        if tag not in self._phase_ctx_cache:
            self._phase_ctx_cache[tag] = self._draw_ctx(tag)
        return self._phase_ctx_cache[tag]

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def on_epoch_start(self, epoch: int) -> None:
        """Refresh the training draw: one fresh context and pair row per
        node per epoch (nothing under per-step sampling)."""
        if self.use_ctx_cache:
            self._get_ctx(("train", epoch))

    def on_resume(self, global_step: int, start_epoch: int) -> None:
        """Continue the per-step generator seeds where an interrupted run
        left off."""
        self._step_count = int(global_step)

    def state_dict(self) -> Dict[str, Any]:
        """The checkpointed state: model, optimizer (with its update count,
        which the schedule reads) and the step count."""
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "step_count": self._step_count,
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self._step_count = int(state["step_count"])

    def should_prune(self, value: float, epoch: int) -> bool:
        """Report the epoch's monitored value to the hp-tuning trial and
        return its pruning decision (False without a trial)."""
        if self.trial is None:
            return False
        self.trial.report(value, epoch)
        return bool(self.trial.should_prune())

    def _epoch_schedule(self, epoch: int) -> np.ndarray:
        """The epoch's shuffled target ids (the JAX package's derivation)."""
        ids = self.train_nodes.copy()
        rng = np.random.default_rng(self.args.seed * 100_003 + epoch)
        rng.shuffle(ids)
        return ids

    def train_batches(self, epoch: int) -> Iterator[Tuple[torch.Tensor, torch.Generator]]:
        """(targets [train_batch_size] on the device, the step's
        generator) for each full batch of the epoch's schedule. The
        schedule goes to the device in one copy."""
        bs = self.args.train_batch_size
        ids = self._epoch_schedule(epoch)
        n_full = len(ids) // bs
        if n_full == 0:
            return
        sched = torch.as_tensor(
            ids[: n_full * bs].reshape(n_full, bs), device=self.device
        )
        for i in range(n_full):
            self._step_count += 1
            gen = torch.Generator(device=self.device)
            gen.manual_seed((self.args.seed * 7_919 + self._step_count) % 2**32)
            yield sched[i], gen

    def sampling_generators(self, step_generator: torch.Generator):
        """The three per-step sampling streams of ``--no-ctx-cache``
        (target contexts, pairs, pair contexts), seeded by hashing the
        step generator's seed with the stream's index."""
        seed = step_generator.initial_seed()
        gens = []
        for i in range(3):
            g = torch.Generator(device=self.device)
            g.manual_seed(int(np.random.SeedSequence([seed, i]).generate_state(1)[0]))
            gens.append(g)
        return gens

    def accumulate_gradients(
        self, targets: torch.Tensor, generator: torch.Generator
    ) -> Dict[str, torch.Tensor]:
        """Zero the gradients, then forward and backward over the
        ``accumulation_step`` micro-batches of ``targets`` in order, each
        loss scaled by 1/accumulation_step, so ``.grad`` holds the mean of
        the micro-batch gradients (summed over the ranks, each rank taking
        its share of every micro-batch). Returns the mean loss, gsr and nfr
        as device scalars, the same on every rank."""
        mesh = self.mesh
        accum = self.args.accumulation_step
        micros = targets.reshape(accum, -1)
        m = micros.shape[1]
        share = local_slice(mesh, m)
        if self.use_ctx_cache:
            if self._train_ctx is None:
                self._get_ctx(("train", 0))
            ctx_ids, ctx_mask, pairs = self._train_ctx
        else:
            b, p = share.stop - share.start, self.sampling.max_total_samples
            g_ctx, g_pairs, g_pair_ctx = self.sampling_generators(generator)
            sampling = (lane_draws(mesh, g_ctx, [(m, b)]), lane_draws(mesh, g_pairs, [(m, b)]),
                        lane_draws(mesh, g_pair_ctx, [(m * p, b * p)]))
        self.optimizer.zero_grad()
        total = None
        for micro in micros[:, share]:
            if self.use_ctx_cache:
                batch = make_pretrain_batch_cached(ctx_ids, ctx_mask, micro, pairs)
            else:
                batch = make_pretrain_batch(self.graph, micro, self.sampling, True,
                                            generators=sampling)
            out = self.model(
                self.feat_tables, batch, deterministic=False, compute_nfr=True,
                generator=generator, mesh=mesh,
            )
            (out.loss / accum).backward()
            part = torch.stack([out.loss, out.gsr_loss, out.nfr_loss]).detach()
            total = part if total is None else total + part
        all_reduce_grads(mesh, self.model.parameters())
        loss, gsr, nfr = all_reduce(mesh, total) / accum
        return {"loss": loss, "gsr": gsr, "nfr": nfr}

    def train_step(self, batch) -> Dict[str, torch.Tensor]:
        """One optimizer step on ``batch`` = (targets, generator) from
        ``train_batches``. Returns the step's mean loss, gsr and nfr as
        device scalars."""
        targets, generator = batch
        metrics = self.accumulate_gradients(targets, generator)
        self.optimizer.step()
        return metrics

    def train_epoch(self, epoch: int) -> torch.Tensor:
        """Refresh the training draw and take every full step of the
        epoch. Returns the per-step losses [steps] on the device; nothing
        inside waits for the device."""
        self.on_epoch_start(epoch)
        losses = [self.train_step(b)["loss"] for b in self.train_batches(epoch)]
        if not losses:
            return torch.zeros((0,), device=self.device)
        return torch.stack(losses)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, split: str = "valid") -> Dict[str, float]:
        """Pair-AUC and mean BCE over the validation nodes' eval pairs
        (one positive and one negative per target). Logits of the bf16
        policy are bf16 values; the AUC and loss are taken from them in
        f32 (the JAX task takes the sigmoid in bf16 numpy)."""
        ctx_ids, ctx_mask, pairs = self._get_ctx((split,))
        nodes = self.valid_nodes
        targets_c, sv_c = rank_chunks(
            self.mesh, self.args.test_batch_size,
            (nodes, np.ones(len(nodes), np.float32)),
            pad_values=(NUM_SPECIAL_NODES, 0),
        )
        proj = self._proj_tables()
        logits_all, labels_all, valid_all = [], [], []
        for targets, sv in zip(targets_c, sv_c):
            targets = torch.as_tensor(targets, device=self.device)
            batch = make_pretrain_batch_cached(ctx_ids, ctx_mask, targets, pairs)
            out = self.model(
                self.feat_tables, batch, deterministic=True, compute_nfr=False,
                proj_tables=proj,
            )
            sv = torch.as_tensor(sv, device=self.device)
            logits_all.append(out.logits.to(torch.float32))
            labels_all.append(batch.labels)
            valid_all.append(batch.pair_valid * sv[:, None])
        logits, labels, valid = (
            gather_chunks(self.mesh, torch.stack(x)).cpu().numpy().ravel()
            for x in (logits_all, labels_all, valid_all))
        valid = valid > 0
        logits, labels = logits[valid], labels[valid]

        probs = stable_sigmoid(logits)
        auc = roc_auc(labels, probs)
        losses = np.maximum(logits, 0) - logits * labels + np.log1p(
            np.exp(-np.abs(logits))
        )
        prefix = "val" if split == "valid" else "test"
        return {f"{prefix}/auc": float(auc), f"{prefix}/loss": float(losses.mean())}

    @torch.no_grad()
    def export_embeddings(self, batch_size: Optional[int] = None) -> np.ndarray:
        """Per-node CLS embeddings over all real nodes in id order →
        [num_nodes, hidden] float32."""
        bs = batch_size or self.args.test_batch_size
        n = self.artifacts.num_nodes
        ctx_ids, ctx_mask, _ = self._get_ctx(("inference",))
        node_ids = np.arange(NUM_SPECIAL_NODES, n + NUM_SPECIAL_NODES)
        (targets_c,) = rank_chunks(self.mesh, bs, (node_ids,), pad_values=(NUM_SPECIAL_NODES,))
        proj = self._proj_tables()
        cls = []
        for targets in targets_c:
            targets = torch.as_tensor(targets, device=self.device)
            hidden = self.model.encode(
                self.feat_tables, ctx_ids[targets], ctx_mask[targets],
                deterministic=True, proj_tables=proj,
            )
            cls.append(hidden[:, 0])
        out = gather_chunks(self.mesh, torch.stack(cls))[:n]
        return out.to(torch.float32).cpu().numpy()

    def _proj_tables(self):
        """Whole-table projections, computed once per call for the
        project_tables dataflow (None under gather_rows)."""
        if self.config.fusion_strategy != "project_tables":
            return None
        return self.model.project_tables(self.feat_tables)


# ----------------------------------------------------------------------
# workload contract (the functions the CLI's ``train_model`` calls)
# ----------------------------------------------------------------------

def feat_tables_dtype(args: TrainArgs) -> str:
    """The feature tables' storage: ``--feat-tables-dtype``, else bf16
    under the bf16 compute policy (the step would cast them to bf16
    anyway), else f32."""
    return str(args.extra.get("feat_tables_dtype")
               or ("bfloat16" if args.mp_enabled else "float32"))


def check_args(args: TrainArgs) -> None:
    if args.early_criterion not in ("loss", "auc"):
        raise ValueError(f"invalid early_criterion {args.early_criterion}")
    if args.mode in ("eval", "inference") and args.run_id is None:
        raise ValueError(f"mode {args.mode} requires --run-id")


def init_run(args: TrainArgs) -> None:
    np.random.seed(args.seed)


def train_valid_split(nodes: np.ndarray, valid_size: float, seed: int):
    """(train, valid) split of ``nodes``: sklearn's ``train_test_split(nodes,
    test_size=valid_size, random_state=seed)`` (``data/split.py``)."""
    return train_test_split(nodes, valid_size, seed)


def init_dataloader(args: TrainArgs, ctx: Dict[str, Any]) -> None:
    """The dataset (``ctx["artifacts"]``, loaded from ``args.data_dir`` /
    ``args.dataset_name`` when absent) and the train/valid node split of
    the real node ids (``train_valid_split`` with ``args.valid_size`` and
    ``args.seed``). With ``args.run_id`` the model and sampling
    hyperparameters come from that run first."""
    if args.run_id is not None:
        _restore_params_from_run(args)
    artifacts = ctx.get("artifacts") or load_artifacts(
        args.data_dir, args.dataset_name
    )
    ctx["artifacts"] = artifacts
    all_nodes = np.arange(
        NUM_SPECIAL_NODES,
        artifacts.num_nodes + NUM_SPECIAL_NODES,
        dtype=np.int32,
    )
    train_nodes, valid_nodes = train_valid_split(
        all_nodes, args.valid_size, args.seed
    )
    ctx["train_nodes"] = train_nodes
    ctx["valid_nodes"] = valid_nodes
    logger.info(
        "PMGT data: %d nodes (%d train / %d valid), graph max_deg %d",
        artifacts.num_nodes,
        len(train_nodes),
        len(valid_nodes),
        artifacts.graph.max_degree,
    )


def _restore_params_from_run(args: TrainArgs) -> None:
    """Reload the model and sampling hyperparameters of a previous run."""
    params = RunRegistry(args.log_dir).get_run(args.run_id).params
    for name in (
        "hidden_size",
        "intermediate_size",
        "num_hidden_layers",
        "num_attention_heads",
        "beta",
        "position_embedding_type",
        "random_node_ratio",
        "mask_node_ratio",
        "max_ctx_neigh",
        "max_total_samples",
        "min_neg_samples",
        "hop_sampling_sizes",
    ):
        if name in params:
            args.extra[name] = params[name]


def init_model(args: TrainArgs, ctx: Dict[str, Any], trial=None) -> None:
    """``ctx["task"]``: a ``PMGTTask`` on ``ctx.get("device", "cuda")``,
    reporting to the hp-tuning ``trial`` if given."""
    ctx["task"] = PMGTTask(
        args, ctx["artifacts"], ctx["train_nodes"], ctx["valid_nodes"],
        device=ctx.get("device", "cuda"), trial=trial,
    )


def _restore_params_only(path: str, task: PMGTTask) -> None:
    """Load only the model from a checkpoint: evaluation and export never
    touch the optimizer state."""
    payload = restore_checkpoint(path)
    task.model.load_state_dict(payload["state"]["model"])


def _maybe_restore(args: TrainArgs, task: PMGTTask, load_best: bool) -> None:
    if args.run_id is None:
        return
    path = locate_eval_ckpt(
        RunRegistry(args.log_dir), None, args.run_id, load_best=load_best
    )
    if path is None:
        return
    _restore_params_only(path, task)
    logger.info("restored checkpoint from %s", path)


def train(args: TrainArgs, ctx: Dict[str, Any], registry, run) -> Dict[str, float]:
    return engine.fit(
        ctx["task"],
        num_epochs=args.num_epochs,
        early=args.early,
        early_criterion=args.early_criterion,
        registry=registry,
        run=run,
        resume=args.run_id is not None,
        swa_start=args.extra.get("swa_start"),
        eval_interval=args.eval_interval,
        ckpt_interval=args.ckpt_interval,
        eval_init=bool(args.extra.get("eval_init", False)),
    )


def test(args: TrainArgs, ctx: Dict[str, Any], registry, run,
         is_hptuning: bool = False) -> Dict[str, float]:
    """Evaluate the best checkpoint on the validation nodes with the test
    phase's draw (the reference reuses valid as test for PMGT); under
    hp-tuning with the validation phase's draw, labelled ``test/``."""
    task: PMGTTask = ctx["task"]
    path = locate_eval_ckpt(registry, run, args.run_id)
    if path is not None:
        _restore_params_only(path, task)
    if is_hptuning:
        metrics = task.evaluate("valid")
        return {k.replace("val/", "test/"): v for k, v in metrics.items()}
    return task.evaluate("test")


def inference(args: TrainArgs, ctx: Dict[str, Any], registry, run) -> np.ndarray:
    """Export the best checkpoint's per-node embeddings [num_nodes,
    hidden] float32, saved to ``args.inference_result_path`` if given."""
    task: PMGTTask = ctx["task"]
    _maybe_restore(args, task, load_best=True)
    emb = task.export_embeddings()
    if args.inference_result_path and task.mesh.is_primary:  # every rank holds the export
        os.makedirs(
            os.path.dirname(os.path.abspath(args.inference_result_path)),
            exist_ok=True,
        )
        np.save(args.inference_result_path, emb)
        logger.info("saved node embeddings to %s", args.inference_result_path)
    barrier(task.mesh)
    return emb
