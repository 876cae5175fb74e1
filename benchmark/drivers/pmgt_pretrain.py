"""PMGT pre-training through ``PMGTTask``: epoch after epoch, the
per-epoch context and pair refresh (``on_epoch_start``) and then
``train_step`` over ``train_batches``.

Set-up runs epoch 0 whole: its first three steps, through the window's
own call and feed, are the ones the plain reference follows from the
seed's weights; the rest warm every shape up, and every step's draws are
kept to hold later epochs' against. The window then runs epochs 1, 2, ...
until ``--seconds`` have passed, and ends in a device sync after the last
step it counts; its metric, the device's time a step, is read from the
window's device trace (``run.py``). After it (``tail``) the same calls
refresh one more epoch and take its first step from the window's state:
the reference follows that step from the program's state, and its draws
have to be fresh.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import common
from benchmark.harness.trace import span
from benchmark.reference import plain, sampler
from benchmark.yardstick import flops, peaks, tgdata

CHECKED_STEPS = 3


def _args(cfg: dict, seed: int):
    from pmgt_tpu_torch.core.config import TrainArgs

    return TrainArgs(
        seed=seed, lr=cfg["lr"], decay=cfg["decay"], mp_enabled=cfg["precision"] == "bfloat16",
        train_batch_size=cfg["train_batch_size"], valid_size=cfg["valid_size"],
        gradient_max_norm=cfg["gradient_max_norm"], num_epochs=cfg["num_epochs"],
        extra=dict(hidden_size=cfg["hidden_size"], intermediate_size=cfg["intermediate_size"],
                   num_hidden_layers=cfg["num_hidden_layers"],
                   num_attention_heads=cfg["num_attention_heads"], beta=cfg["beta"],
                   attention_impl=cfg["attention_impl"], max_ctx_neigh=cfg["max_ctx_neigh"],
                   hop_sampling_sizes=tuple(cfg["hop_sampling_sizes"]),
                   max_total_samples=cfg["max_total_samples"],
                   min_neg_samples=cfg["min_neg_samples"],
                   random_node_ratio=cfg["random_node_ratio"],
                   mask_node_ratio=cfg["mask_node_ratio"]))


class _Capture:
    """The model's inputs of each call, taken by a forward pre-hook."""

    def __init__(self, model):
        self.batches = []
        self.handle = model.register_forward_pre_hook(self._hook)

    def _hook(self, module, args):
        self.batches.append({k: v.detach().clone() for k, v in args[1]._asdict().items()})

    def close(self):
        self.handle.remove()
        return [{k: v.cpu() for k, v in b.items()} for b in self.batches]


def _draws_by_node(batches, num_total: int):
    """{"ctx": [num_total, S], "pairs": [num_total, P]}: each target's
    context and pair nodes as the batches drew them (-1 where a node was
    no target)."""
    s, p = batches[0]["target_ids"].shape[1], batches[0]["pair_ids"].shape[1]
    ctx = torch.full((num_total, s), -1, dtype=torch.int64)
    pairs = torch.full((num_total, p), -1, dtype=torch.int64)
    for b in batches:
        node = b["target_ids"][:, 0].long()
        ctx[node] = b["target_ids"].long()
        pairs[node] = b["pair_ids"][:, :, 0].long()
    return {"ctx": ctx, "pairs": pairs}


def setup(run) -> dict:
    from pmgt_tpu_torch.tasks.pmgt_task import PMGTTask

    cfg = run.cell.config
    plain.set_f32_matmul()
    raw = common.dataset(cfg, run.seed)
    pseed = common.derive_seed(run.seed, common.PROGRAM)
    nodes = np.arange(2, raw.num_nodes + 2, dtype=np.int32)
    train_nodes, valid_nodes = tgdata.train_test_split(nodes, cfg["valid_size"], pseed)
    task = PMGTTask(_args(cfg, pseed), common.program_artifacts(raw), train_nodes, valid_nodes,
                    device=run.device)
    task.model.load_state_dict(common.make_weights(common.pretrain_shapes(cfg), cfg, run.seed,
                                                   run.device))
    params = dict(task.model.named_parameters())
    task.on_epoch_start(0)
    cap = _Capture(task.model)
    steps = []
    for i, batch in enumerate(task.train_batches(0)):
        if i < CHECKED_STEPS:
            targets, gen = batch
            loss = task.train_step(batch)["loss"]
            rec = {"seed": gen.initial_seed(), "loss": float(loss), "targets": targets.cpu()}
            if i == 0:
                rec["grad"] = common.first_gradient(task.optimizer.inner, params)
            if i == CHECKED_STEPS - 1:
                rec["params"] = {n: p.detach().cpu().clone() for n, p in params.items()}
            steps.append(rec)
        else:
            task.train_step(batch)
    common.sync(run.device)
    batches = cap.close()
    for rec, b in zip(steps, batches):
        rec["batch"] = b
    rows = [len(torch.unique(torch.cat([b["target_ids"].flatten(), b["pair_ids"].flatten()])))
            for b in batches[:CHECKED_STEPS]]
    lanes = cfg["train_batch_size"] * (2 + cfg["max_total_samples"])
    return {"task": task, "raw": raw, "steps": steps, "epoch": 1, "cfg": cfg,
            "seed": run.seed, "device": run.device,
            "epoch0": _draws_by_node(batches, raw.num_nodes + 2),
            "setup_params": common.snapshot(params),
            "step_flops": flops.pretrain_step_flops(cfg, lanes, float(np.mean(rows))),
            "kernel_work": peaks.attention_calls(cfg, lanes, training=True),
            "step_nodes": cfg["train_batch_size"]}


def _steps(state, stop, trace: bool):
    """Run epochs from ``state["epoch"]`` until ``stop(steps, epochs)``;
    returns (steps, epochs) completed. Traced, each refresh sits between
    device syncs in its own span."""
    task = state["task"]
    steps = epochs = 0
    while not stop(steps, epochs):
        e = state["epoch"]
        if trace:
            common.sync(state["device"])
            with span("refresh"):
                task.on_epoch_start(e)
                common.sync(state["device"])
        else:
            task.on_epoch_start(e)
        for batch in task.train_batches(e):
            if trace:
                with span("step"):
                    task.train_step(batch)
            else:
                task.train_step(batch)
            steps += 1
            if stop(steps, epochs):
                break
        else:
            state["epoch"] += 1
            epochs += 1
    return steps, epochs


def window(state, seconds: float, tick=None) -> dict:
    """Epochs until ``seconds`` have passed; ``tick()``, where given, is
    called between steps."""
    common.sync(state["device"])
    t0 = time.perf_counter()

    def stop(steps, epochs):
        if tick is not None:
            tick()
        return time.perf_counter() - t0 >= seconds

    steps, _ = _steps(state, stop, False)
    common.sync(state["device"])
    elapsed = time.perf_counter() - t0
    return {"attempted": steps, "failed": 0, "metrics": {}, "window_s": elapsed}


def traced(state, params: dict):
    epochs = int(params["trace_epochs"])

    def run():
        steps, _ = _steps(state, lambda s, e: e >= epochs, True)
        common.sync(state["device"])
        return steps, {"kernel_work": state["kernel_work"], "flops": steps * state["step_flops"],
                       "peak_flops": state["cfg"]["precision"],
                       "nodes": steps * state["step_nodes"]}
    return run


def tail(state) -> None:
    """After the window: one more epoch's refresh and its first step,
    through the window's calls, from the window's state; the state before
    and after it and the model's input are kept for the check."""
    task = state["task"]
    e = state["epoch"] + 1  # an epoch the window never started
    task.on_epoch_start(e)
    batch = next(iter(task.train_batches(e)))
    params = dict(task.model.named_parameters())
    before = common.snapshot(params)
    moments = common.adam_state(task.optimizer.inner, params)
    cap = _Capture(task.model)
    loss = task.train_step(batch)["loss"]
    common.sync(state["device"])
    state["tail"] = {"seed": batch[1].initial_seed(), "loss": float(loss),
                     "targets": batch[0].cpu(), "batch": cap.close()[0], "before": before,
                     "moments": moments, "after": common.snapshot(params),
                     "m_after": common.adam_state(task.optimizer.inner, params)[0]}


def release(state) -> None:
    state.pop("task", None)


def _held(cfg: dict, raw, adj, batch: dict, targets) -> tuple:
    """(feed mismatches, sampler violations) of one step's captured input:
    the model's targets against the step's, each context and pair row
    against the sampler's guarantees from the raw edges."""
    s = batch["pair_ids"].shape[2]
    hops = len(cfg["hop_sampling_sizes"])
    max_pos = cfg["max_total_samples"] - cfg["min_neg_samples"]
    bad = sampler.context_violations(adj, batch["target_ids"], batch["target_mask"],
                                     batch["target_ids"][:, 0], hops)
    bad += sampler.context_violations(adj, batch["pair_ids"].reshape(-1, s),
                                      batch["pair_mask"].reshape(-1, s),
                                      batch["pair_ids"].reshape(-1, s)[:, 0], hops)
    bad += sampler.pair_violations(adj, batch["target_ids"][:, 0], batch["pair_ids"][:, :, 0],
                                   batch["labels"], batch["pair_valid"], max_pos, raw.num_nodes)
    return common.mismatch(batch["target_ids"][:, 0], targets), bad


def stale_share(epoch0: dict, batch: dict) -> float:
    """The larger share, of contexts and of pair rows, of the step's
    targets whose draw is epoch 0's again (targets that epoch 0 never drew
    left out; 1 where none is left)."""
    node = batch["target_ids"][:, 0].long()
    seen = epoch0["ctx"][node, 0] >= 0
    if not bool(seen.any()):
        return 1.0
    node = node[seen]
    ctx = (epoch0["ctx"][node] == batch["target_ids"][seen].long()).all(1)
    pairs = (epoch0["pairs"][node] == batch["pair_ids"][seen][:, :, 0].long()).all(1)
    return max(float(ctx.float().mean()), float(pairs.float().mean()))


def check(state) -> list:
    """The plain reference over the three checked steps from the seed's
    weights and over the step after the window from the program's state,
    each from its own seed; every checked step's input held to its feed
    and to the sampler's guarantees; the window's draws fresh; every leaf
    moved over the window."""
    cfg, raw, steps, tail = state["cfg"], state["raw"], state["steps"], state["tail"]
    dev = state["device"]
    plain.set_f32_matmul()
    adj = sampler.adjacency(raw.num_nodes, raw.edges, dev)
    feed_bad = s_bad = 0
    for rec in steps + [tail]:
        f, b = _held(cfg, raw, adj, rec["batch"], rec["targets"])
        feed_bad, s_bad = feed_bad + f, s_bad + b
    got = {"losses": [r["loss"] for r in steps], "grad": steps[0]["grad"],
           "params": steps[-1]["params"]}
    ref = reference_steps(state, "f32", dev)
    gaps = common.train_gaps(got, ref)
    gaps.update(common.tail_gaps(common.tail_of_program(tail), reference_tail(state, "f32", dev),
                                 tail["before"]))
    gaps["stale_draws"] = stale_share(state["epoch0"], tail["batch"])
    gaps["window_unmoved"] = common.unmoved(state["setup_params"], tail["before"], ref["grad"])
    state["readings"] = gaps
    return [common.check("feed_violations", feed_bad, 0),
            common.check("sampler_violations", s_bad, 0),
            common.check("window_unmoved", gaps["window_unmoved"], 0)] + [
        common.check(n, gaps[n], limit) for n, limit in cfg["limits"].items() if n in gaps]


def control(state, precision: str, dev, fault=None) -> dict:
    """The reference in ``precision`` (or with ``fault`` planted) put in
    the program's place: its numbers against the f32 reference."""
    out = common.train_gaps(reference_steps(state, precision, dev, fault),
                            reference_steps(state, "f32", dev))
    out.update(common.tail_gaps(reference_tail(state, precision, dev, fault),
                                reference_tail(state, "f32", dev), state["tail"]["before"]))
    return out


def _follow(state, w: dict, opt, recs, precision: str, dev, fault=None) -> dict:
    """The reference's steps over ``recs`` from weights ``w`` and ``opt``:
    each step's loss, the first step's gradient as the update took it, the
    weights after the last."""
    cfg, raw = state["cfg"], state["raw"]
    ar = plain.Arith(precision)
    feats = [torch.as_tensor(t, device=dev) for t in raw.feat_tables]
    for t in w.values():
        t.requires_grad_(True)
    names = list(w)
    losses, first = [], None
    for rec in recs:
        batch = {k: v.to(dev) for k, v in rec["batch"].items()}
        if fault == "half_batch":  # half the targets left out, the mean over the rest
            batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        loss = plain.pretrain_loss(w, cfg, ar, feats, raw.num_nodes, batch,
                                   plain.Draws(rec["seed"], dev))
        grads = opt.clipped(dict(zip(names, torch.autograd.grad(loss, [w[n] for n in names]))))
        if first is None:
            first = {n: g.detach().cpu() for n, g in grads.items()}
        losses.append(float(loss.detach()))
        opt.step(w, grads)
    return {"losses": losses, "grad": first,
            "params": {n: t.detach().cpu() for n, t in w.items()}}


def reference_steps(state, precision: str, dev, fault=None) -> dict:
    """The reference's losses, first gradient and parameters after the
    checked steps, from the seed's weights."""
    cfg = state["cfg"]
    w = common.make_weights(common.pretrain_shapes(cfg), cfg, state["seed"], dev)
    w0 = {n: t.detach().cpu().clone() for n, t in w.items()}
    opt = plain.AdamW(w, cfg["lr"], cfg["decay"], cfg["gradient_max_norm"])
    out = _follow(state, w, opt, state["steps"], precision, dev, fault)
    out["w0"] = w0
    return out


def reference_tail(state, precision: str, dev, fault=None) -> dict:
    """The reference's step after the window, from the program's weights
    and optimizer state before it: {"loss", "grad", "after"}."""
    cfg, tail = state["cfg"], state["tail"]
    w, opt = common.resume(tail, cfg, dev)
    out = _follow(state, w, opt, [tail], precision, dev, fault)
    return {"loss": out["losses"][0], "grad": out["grad"], "after": out["params"]}
