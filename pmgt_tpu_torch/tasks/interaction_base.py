"""Shared plumbing of the pointwise user-item workloads NCF, DCN and
PMGT_NCF (counterpart of ``pmgt_tpu/tasks/interaction_base.py``).

- ``InteractionTaskBase.export_topk``: the full-catalogue top-k of every
  user, training positives excluded by default. Users go in batches, the
  catalogue in chunks; each chunk's scores are merged into the running
  top-k with the carry first, by a stable descending sort, so ties resolve
  to the lower item id as ``jax.lax.top_k`` resolves them. Excluded and
  past-the-end items score -inf (a mask, never an out-of-range scatter),
  and every -inf slot is served as item id -1.
- ``InteractionTaskBase``: also the engine's Task protocol as ``PMGTTask``
  implements it. Each epoch's examples (``epoch_training_arrays``: every
  positive pair plus ``num_ng`` negatives, from a generator seeded
  ``seed * 7_001 + epoch``, shuffled by ``default_rng(seed * 11 +
  epoch)``) are keyed on the epoch, so a step never trains on another
  epoch's negatives. Step i of epoch e gets a generator seeded ``seed * 13
  + e * 100_003 + i`` for its dropout; gradients are the mean over
  ``accumulation_step`` micro-batches. With ``freeze_item_init_emb`` (and
  an ``item_init_emb_path``) the ``frozen_param`` table gets zeroed
  gradients and no weight decay.
- ``ranking_evaluate``: the NCF protocol — each evaluated user's candidate
  list (``build_eval_candidates``, drawn once per split from a generator
  seeded ``seed * 17 + (split == "test")``) scored, the top 100 ranked,
  NDCG/recall against the split's positives, and the loss as the mean of
  per-chunk masked BCE means over chunks of ``eval_chunk_users`` users
  (the JAX chunk size, which the mean depends on).

Data parallelism (``--num-devices``, ``core/mesh``): every rank draws the
same examples; rank r takes the r-th contiguous 1/N of each micro-batch,
draws its dropout as the rows of the global micro-batch's draw
(``core/mesh.lane_draws``) and the gradients are summed over the ranks.
Evaluation chunks and serving user batches are padded to a multiple of the
world size, each rank scores its share of every chunk, and the outputs
(top-k lists, per-chunk loss sums) are gathered or summed on every rank.

Generator seeds are the JAX package's key integers reduced mod 2**32; the
streams are torch's.
"""
from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from pmgt_tpu_torch.core.config import TrainArgs
from pmgt_tpu_torch.core.device import resolve_device
from pmgt_tpu_torch.core.mesh import (
    Mesh,
    all_reduce,
    all_reduce_grads,
    barrier,
    gather_chunks,
    lane_draws,
    local_slice,
    make_mesh,
    rank_chunks,
    replicate,
)
from pmgt_tpu_torch.core.tracing import span
from pmgt_tpu_torch.data.interactions import (
    InteractionData,
    build_eval_candidates,
    epoch_training_arrays,
)
from pmgt_tpu_torch.metrics.ranking import get_ndcg, get_recall
from pmgt_tpu_torch.models.pmgt import bce_with_logits
from pmgt_tpu_torch.sampling.mcn import topk_lowest_index
from pmgt_tpu_torch.train import engine
from pmgt_tpu_torch.train.checkpoints import restore_checkpoint
from pmgt_tpu_torch.train.optim import make_optimizer
from pmgt_tpu_torch.train.registry import locate_eval_ckpt

logger = logging.getLogger("pmgt_tpu_torch")

TOPK = 100  # candidates ranked per user (reference ncf/trainer.py:213-214)

# Scores (user ids [P], item ids [P]) → logits [P], deterministic.
Scorer = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def seeded(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded ``seed mod 2**32``."""
    return torch.Generator(device=device).manual_seed(int(seed) % 2**32)


def masked_bce_sums(logits, labels, mask, chunks: int):
    """Per-chunk sums of masked BCE and of the mask, over ``chunks`` equal
    row groups → ([chunks], [chunks])."""
    bce = bce_with_logits(logits, labels) * mask
    return bce.reshape(chunks, -1).sum(1), mask.reshape(chunks, -1).sum(1)


class InteractionTaskBase:
    """Subclasses build ``self.model`` (scoring (user, item) → logit, with
    ``init_weights(generator)``), call ``finish_init(state)`` and implement
    ``evaluate``; ``scorer()`` returns the deterministic scorer of
    evaluation and serving (built once per call of either)."""

    # table frozen by freeze_item_init_emb (reference ncf/trainer.py:179,
    # dcn/trainer.py:138)
    frozen_param: Optional[str] = None
    eval_chunk_users = 32  # ranking_evaluate's loss chunk (JAX: test_batch_size // 8)
    eval_chunks_per_call = 1  # chunks scored per model call

    def __init__(self, args: TrainArgs, train_data: InteractionData,
                 valid_data: InteractionData, test_data: InteractionData,
                 device="cuda", trial=None):
        self.device = resolve_device(device)
        self.args = args
        self.trial = trial  # an hp-tuning trial, with pruning enabled
        self.train_data = train_data
        self.valid_data = valid_data
        self.test_data = test_data
        self.mesh = make_mesh(args.num_devices, self.device)
        n_dev = self.mesh.size
        if args.train_batch_size % (n_dev * args.accumulation_step):
            raise ValueError(
                f"train_batch_size {args.train_batch_size} must be divisible "
                f"by num_devices*accumulation ({n_dev}*{args.accumulation_step})"
            )
        self.num_ng = args.extra.get("num_ng", 1)
        self._epoch_arrays: Optional[Tuple[torch.Tensor, ...]] = None
        self._epoch_arrays_epoch: Optional[int] = None
        self._eval_cache: Dict[str, Any] = {}

    def finish_init(self, state: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """Load ``state`` (pretrained or fused parameters) into the model,
        move it to the device and build the optimizer."""
        args = self.args
        if state is not None:
            self.model.load_state_dict(state)
        replicate(self.mesh, self.model.to(self.device).train())
        m = len(self.train_data.pairs) * (1 + self.num_ng)
        extra = args.extra
        self.frozen = (self.frozen_param if extra.get("freeze_item_init_emb")
                       and extra.get("item_init_emb_path") else None)
        self.optimizer = make_optimizer(
            self.model,
            optim=args.optim,
            lr=args.lr,
            decay=args.decay,
            scheduler_type=args.scheduler_type,
            total_steps=max(m // args.train_batch_size, 1) * args.num_epochs,
            warmup_ratio=args.scheduler_warmup,
            gradient_max_norm=args.gradient_max_norm,
            frozen_names=(self.frozen,) if self.frozen else (),
        )

    # ------------------------------------------------------------------
    # engine Task protocol
    # ------------------------------------------------------------------
    def on_epoch_start(self, epoch: int) -> None:
        """Draw the epoch's examples (no-op if they are this epoch's), in a
        ``negatives`` span."""
        if self._epoch_arrays_epoch == epoch:
            return
        with span("negatives"):
            users, items, labels = epoch_training_arrays(
                self.train_data, self.num_ng,
                seeded(self.args.seed * 7_001 + epoch, self.device))
            perm = np.random.default_rng(self.args.seed * 11 + epoch).permutation(len(users))
            self._epoch_arrays = tuple(
                torch.as_tensor(a[perm], device=self.device) for a in (users, items, labels)
            )
        self._epoch_arrays_epoch = epoch

    def state_dict(self) -> Dict[str, Any]:
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])

    def should_prune(self, value: float, epoch: int) -> bool:
        """Report the epoch's monitored value to the hp-tuning trial and
        return its pruning decision (False without a trial)."""
        if self.trial is None:
            return False
        self.trial.report(value, epoch)
        return bool(self.trial.should_prune())

    def train_batches(self, epoch: int) -> Iterator[Tuple[torch.Tensor, ...]]:
        """(users, items, labels, generator) for each full batch of the
        epoch (a partial last batch is dropped). Each batch's making is a
        ``batch`` span that closes before the batch is handed over."""
        self.on_epoch_start(epoch)
        users, items, labels = self._epoch_arrays
        bs = self.args.train_batch_size
        for i in range(len(users) // bs):
            with span("batch"):
                sl = slice(i * bs, (i + 1) * bs)
                gen = seeded(self.args.seed * 13 + epoch * 100_003 + i, self.device)
                batch = users[sl], items[sl], labels[sl], gen
            yield batch

    def train_logits(self, users, items, generator) -> torch.Tensor:
        return self.model(users, items, deterministic=False, generator=generator)

    def accumulate_gradients(self, batch) -> torch.Tensor:
        """Zero the gradients, then forward and backward each of the
        ``accumulation_step`` micro-batches in order (loss scaled by
        1/accumulation_step), so ``.grad`` holds their mean gradient; a
        frozen table's gradient is zeroed. Each rank takes its share of
        every micro-batch; the ranks' shares are equal, so the global mean
        is the mean of the ranks' means and each rank's part is its mean
        over the world size. Returns the mean loss on the device, the same
        on every rank. Spans: each micro-batch's scoring and loss is a
        ``forward`` (lanes: its pairs), its gradient a ``backward``."""
        users, items, labels, gen = batch
        mesh, accum = self.mesh, self.args.accumulation_step
        m = users.shape[0] // accum
        share = local_slice(mesh, m)
        gen = lane_draws(mesh, gen, [(m, share.stop - share.start)])
        self.optimizer.zero_grad()
        total = None
        for u, i, lab in zip(*(x.reshape(accum, -1)[:, share] for x in (users, items, labels))):
            with span("forward", lanes=int(u.shape[0])):
                loss = torch.mean(bce_with_logits(self.train_logits(u, i, gen), lab)) / mesh.size
            with span("backward"):
                (loss / accum).backward()
            total = loss.detach() if total is None else total + loss.detach()
        all_reduce_grads(mesh, self.model.parameters())
        total = all_reduce(mesh, total)
        if self.frozen:
            for p in getattr(self.model, self.frozen).parameters():
                if p.grad is not None:
                    p.grad.zero_()
        return total / accum

    def train_step(self, batch) -> Dict[str, torch.Tensor]:
        """One optimizer step on a batch of ``train_batches``, in a
        ``step`` span."""
        with span("step", examples=int(batch[0].shape[0])):
            loss = self.accumulate_gradients(batch)
            self.optimizer.step()
        return {"loss": loss}

    def train_epoch(self, epoch: int) -> torch.Tensor:
        """Every full step of the epoch → per-step losses [steps] on the
        device (nothing waits for the device)."""
        losses = [self.train_step(b)["loss"] for b in self.train_batches(epoch)]
        if not losses:
            return torch.zeros((0,), device=self.device)
        return torch.stack(losses)

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------
    def scorer(self) -> Scorer:
        model = self.model
        return lambda users, items: model(users, items, deterministic=True)

    def _merge_chunk(self, score: Scorer, users, pos, start: int, chunk: int,
                     k: int, exclude: bool, carry):
        """Score the users [B] against items [start, start + chunk) and
        merge them into ``carry`` = (ids [B, k], scores [B, k]). Spans: the
        tile (items: those of the catalogue, past-the-end padding left out),
        inside it ``forward`` (the scoring of its users × chunk lanes) and
        ``merge`` (the rest)."""
        data = self.train_data
        dev = users.device
        b = users.shape[0]
        with span("tile", items=max(min(chunk, int(data.num_items) - start), 0)):
            with span("forward", lanes=b * chunk):
                items = start + torch.arange(chunk, device=dev)
                u = torch.clamp(users, max=max(data.num_users - 1, 0))[:, None].expand(b, chunk)
                it = torch.clamp(items, max=data.num_items - 1)[None, :].expand(b, chunk)
                logits = score(u.reshape(-1), it.reshape(-1)).reshape(b, chunk).float()
            with span("merge"):
                neg_inf = torch.tensor(float("-inf"), device=dev)
                if exclude:
                    # Positives outside the chunk (and the num_items padding)
                    # go to a spare column that is dropped.
                    idx = pos - start
                    idx = torch.where((idx >= 0) & (idx < chunk), idx, chunk)
                    padded = torch.cat([logits, torch.zeros(b, 1, device=dev)], dim=1)
                    logits = padded.scatter(1, idx, neg_inf.expand(idx.shape))[:, :chunk]
                logits = torch.where(items[None, :] < data.num_items, logits, neg_inf)
                all_ids = torch.cat([carry[0], items[None, :].expand(b, chunk)], dim=1)
                all_sc = torch.cat([carry[1], logits], dim=1)
                best, idx = topk_lowest_index(all_sc, k)
                return torch.gather(all_ids, 1, idx), best

    def positives(self) -> np.ndarray:
        """[num_users, P] int32: each user's training positives (rows of
        ``train_data.user_pos``), padded with num_items; users absent from
        the training split get an all-padding row."""
        data = self.train_data
        maxp = data.user_pos.shape[1]
        pos = np.full((data.num_users, max(maxp, 1)), data.num_items, np.int32)
        if maxp and len(data.unique_users):
            pos[data.unique_users, :maxp] = data.user_pos
        return pos

    @torch.no_grad()
    def serve_users(self, score: Scorer, users: torch.Tensor, pos: torch.Tensor, k: int,
                    item_chunk: int, exclude_train: bool = True):
        """The top-k (ids [B, k], scores [B, k]) of users [B] (positives
        ``pos`` [B, P]) over the whole catalogue, ``item_chunk`` items at
        a time (k <= item_chunk <= num_items), in a ``serve`` span."""
        b, dev = users.shape[0], users.device
        with span("serve", users=b):
            carry = (torch.zeros(b, k, dtype=torch.int64, device=dev),
                     torch.full((b, k), float("-inf"), device=dev))
            for start in range(0, int(self.train_data.num_items), item_chunk):
                carry = self._merge_chunk(score, users, pos, start, item_chunk, k,
                                          exclude_train, carry)
        return carry

    @torch.no_grad()
    def export_topk(self, k: int = TOPK, user_batch: int = 256, item_chunk: int = 8192,
                    exclude_train: bool = True) -> Dict[str, np.ndarray]:
        """For every user id in [0, num_users), the ``k`` highest-scoring
        items → {"user_ids": [U], "item_ids": [U, k] int32 (-1 on -inf
        slots), "scores": [U, k] float32}."""
        num_items, num_users = int(self.train_data.num_items), int(self.train_data.num_users)
        k = min(k, num_items)
        # a chunk must be able to hold the whole top-k
        item_chunk = min(max(item_chunk, k), num_items)
        all_users = np.arange(num_users, dtype=np.int32)
        users_c, pos_c = rank_chunks(self.mesh, min(user_batch, num_users),
                                     (all_users, self.positives()))
        score = self.scorer()
        ids_out, sc_out = [], []
        for users_b, pos_b in zip(users_c, pos_c):
            ids, sc = self.serve_users(
                score,
                torch.as_tensor(users_b, dtype=torch.int64, device=self.device),
                torch.as_tensor(pos_b, dtype=torch.int64, device=self.device),
                k, item_chunk, exclude_train,
            )
            ids_out.append(ids)
            sc_out.append(sc)
        scores = gather_chunks(self.mesh, torch.stack(sc_out))[:num_users]
        item_ids = gather_chunks(self.mesh, torch.stack(ids_out))[:num_users]
        scores = scores.cpu().numpy().astype(np.float32)
        item_ids = item_ids.cpu().numpy().astype(np.int32)
        item_ids = np.where(np.isneginf(scores), np.int32(-1), item_ids)
        return {"user_ids": all_users, "item_ids": item_ids, "scores": scores}

    # ------------------------------------------------------------------
    @torch.no_grad()
    def ranking_evaluate(self, split: str = "valid") -> Dict[str, float]:
        """The NCF ranking protocol on the valid or test split: val/loss,
        n20, r20, or test/loss, n10, r10, n20, r20."""
        data = self.valid_data if split == "valid" else self.test_data
        if split not in self._eval_cache:
            users, cands, mask, labels = build_eval_candidates(
                data,
                self.args.extra.get("max_sample_items", 1000),
                seeded(self.args.seed * 17 + (split == "test"), self.device),
                reference_tiebreak=bool(self.args.extra.get("reference_tiebreak", False)),
            )
            arrays = rank_chunks(self.mesh, self.eval_chunk_users, (users, cands, mask, labels))
            self._eval_cache[split] = (len(users), [
                torch.as_tensor(a, device=self.device, dtype=dt)
                for a, dt in zip(arrays, (torch.int64, torch.int64, torch.float32, torch.float32))
            ])
        n, (users_c, cands_c, mask_c, labels_c) = self._eval_cache[split]
        score = self.scorer()
        tops, sums, cnts = [], [], []
        g = self.eval_chunks_per_call
        for c0 in range(0, users_c.shape[0], g):
            sl = slice(c0, c0 + g)
            cands, mask, labels = (x[sl].flatten(0, 1) for x in (cands_c, mask_c, labels_c))
            users = users_c[sl].reshape(-1)
            logits = score(users[:, None].expand(cands.shape).reshape(-1),
                           cands.reshape(-1)).reshape(cands.shape)
            masked = torch.where(mask > 0, logits, torch.finfo(logits.dtype).min)
            _, idx = topk_lowest_index(masked, min(TOPK, cands.shape[1]))
            tops.append(torch.gather(cands, 1, idx))
            s, c = masked_bce_sums(logits, labels, mask, users_c[sl].shape[0])
            sums.append(s)
            cnts.append(c)
        tops = torch.cat(tops).reshape(users_c.shape[:2] + (-1,))
        prediction = gather_chunks(self.mesh, tops)[:n].cpu().numpy()
        sums, cnts = (all_reduce(self.mesh, torch.cat(x)).cpu().numpy() for x in (sums, cnts))
        gt_sets = [data.user_pos[r, : data.user_pos_count[r]].tolist() for r in range(n)]
        prefix = "val" if split == "valid" else "test"
        results = {f"{prefix}/loss": float(np.mean(sums / np.maximum(cnts, 1)))}
        for k in ((20,) if split == "valid" else (10, 20)):
            results[f"{prefix}/n{k}"] = get_ndcg(prediction, gt_sets, top=k)
            results[f"{prefix}/r{k}"] = get_recall(prediction, gt_sets, top=k)
        return results


# ----------------------------------------------------------------------
# the workload contract's shared parts (``init_run``, ``train`` and
# ``test`` are the same for the three workloads)
# ----------------------------------------------------------------------

def split_interactions(args: TrainArgs, artifacts) -> Dict[str, InteractionData]:
    """train/valid/test ``InteractionData`` (train/valid split of the
    training pairs by ``train_valid_split`` with ``args.valid_size`` and
    ``args.seed``)."""
    from pmgt_tpu_torch.data.interactions import train_valid_split

    train_pairs, valid_pairs = train_valid_split(artifacts.train_pairs, args.valid_size, args.seed)
    nu, ni = artifacts.num_users, artifacts.num_items
    return {
        "train_data": InteractionData.build(train_pairs, nu, ni),
        "valid_data": InteractionData.build(valid_pairs, nu, ni),
        "test_data": InteractionData.build(artifacts.test_pairs, nu, ni),
    }


def init_run(args: TrainArgs) -> None:
    np.random.seed(args.seed)


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
    """The best checkpoint's metrics on the test split; under hp-tuning
    on the validation split, labelled ``test/`` (the reference's leakage
    guard: a search never reads the test split)."""
    task = ctx["task"]
    restore_eval_params(task, registry, run, args.run_id)
    if is_hptuning:
        metrics = task.evaluate("valid")
        return {k.replace("val/", "test/"): v for k, v in metrics.items()}
    return task.evaluate("test")


def restore_eval_params(task, registry, run, run_id) -> None:
    """Load the model of the run's best checkpoint (``locate_eval_ckpt``)
    into ``task``, if there is one."""
    path = locate_eval_ckpt(registry, run, run_id)
    if path is not None:
        task.model.load_state_dict(restore_checkpoint(path)["state"]["model"])
        logger.info("restored checkpoint from %s", path)


def save_topk(args: TrainArgs, out: Dict[str, np.ndarray], mesh: Mesh) -> None:
    """Write ``out`` to ``args.inference_result_path`` (rank 0 only;
    every rank holds the gathered result) and wait until it is written."""
    if args.inference_result_path and mesh.is_primary:
        np.savez(args.inference_result_path, **out)
        logger.info("wrote top-%d recommendations for %d users to %s",
                    out["item_ids"].shape[1], len(out["user_ids"]),
                    args.inference_result_path)
    barrier(mesh)
