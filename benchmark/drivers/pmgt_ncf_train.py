"""PMGT_NCF training through ``PMGTNCFTask``: ``train_step`` over
``train_batches(0)``, then the next epochs'.

Set-up draws epoch 0's negatives and contexts (``on_epoch_start``) and
takes the epoch's first steps through the window's own call and feed:
the first three are the ones the plain reference follows from the seed's
weights, and they warm every shape up. The window goes on with the
epoch's next steps (an epoch is some thousands of steps, more than a
window holds) until ``--seconds`` have passed, and ends in a device sync
after the last step it counts. After it (``tail``) the same call takes
the next step from the window's state, which the reference follows from
the program's state.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.drivers import pmgt_ncf_common as pc
from benchmark.harness import common
from benchmark.harness.trace import span
from benchmark.reference import plain, sampler
from benchmark.yardstick import flops, peaks

CHECKED_STEPS = 3
WARM_STEPS = 8


class _Capture:
    """The users and item sequences each model call took (a forward
    pre-hook) and the encoder's CLS states of the items (a forward hook on
    the encoder)."""

    def __init__(self, model):
        self.calls = []
        self.handles = [model.register_forward_pre_hook(self._inputs, with_kwargs=True),
                        model.bert.register_forward_hook(self._cls)]

    def _inputs(self, module, args, kwargs):
        self.calls.append({"model_users": args[1].detach().clone(),
                           "seq_ids": args[2].detach().clone(), "seq_mask": args[3].detach().clone()})

    def _cls(self, module, args, out):
        self.calls[-1]["cls"] = out[:, 0].detach().float().clone()

    def close(self):
        for h in self.handles:
            h.remove()
        return [{k: v.cpu() for k, v in c.items()} for c in self.calls]


def _record(batch, loss) -> dict:
    users, items, labels, gen = batch
    return {"seed": gen.initial_seed(), "loss": float(loss),
            "users": users.cpu(), "items": items.cpu(), "labels": labels.cpu()}


def setup(run) -> dict:
    state = pc.build(run)
    task, cfg = state["task"], state["cfg"]
    params = dict(task.model.named_parameters())
    batches = _epochs(task)
    cap = _Capture(task.model)
    steps = []
    for i in range(WARM_STEPS):
        batch = next(batches)
        loss = task.train_step(batch)["loss"]
        if i >= CHECKED_STEPS:
            continue
        rec = _record(batch, loss)
        if i == 0:
            rec["grad"] = common.first_gradient(task.optimizer.inner, params)
        if i == CHECKED_STEPS - 1:
            rec["params"] = common.snapshot(params)
            for r, c in zip(steps + [rec], cap.close()):
                r.update(c)
        steps.append(rec)
    common.sync(run.device)
    rows = [len(torch.unique(r["seq_ids"])) for r in steps]
    state.update(batches=batches, steps=steps, setup_params=common.snapshot(params),
                 step_flops=flops.pmgt_ncf_train_step_flops(cfg, cfg["train_batch_size"],
                                                            float(np.mean(rows))),
                 kernel_work=peaks.attention_calls(cfg, cfg["train_batch_size"], training=True))
    return state


def _epochs(task):
    """``train_batches`` of epoch 0, 1, ...: each epoch draws its
    negatives and contexts first, as training does."""
    epoch = 0
    while True:
        yield from task.train_batches(epoch)
        epoch += 1


def _run(state, stop, trace: bool) -> int:
    task, batches = state["task"], state["batches"]
    n = 0
    while not stop(n):
        batch = next(batches)
        if trace:
            with span("step"):
                task.train_step(batch)
        else:
            task.train_step(batch)
        n += 1
    return n


def window(state, seconds: float, tick=None) -> dict:
    """Steps until ``seconds`` have passed; ``tick()``, where given, is
    called between steps."""
    common.sync(state["device"])
    t0 = time.perf_counter()

    def stop(n):
        if tick is not None:
            tick()
        return time.perf_counter() - t0 >= seconds

    n = _run(state, stop, False)
    common.sync(state["device"])
    elapsed = time.perf_counter() - t0
    return {"attempted": n, "failed": 0, "window_s": elapsed,
            "metrics": {"pmgt_ncf_train_pairs_per_s":
                        n * state["cfg"]["train_batch_size"] / elapsed}}


def traced(state, params: dict):
    steps = int(params["trace_steps"])

    def run():
        n = _run(state, lambda n: n >= steps, True)
        common.sync(state["device"])
        return n, {"kernel_work": state["kernel_work"], "flops": n * state["step_flops"],
                   "peak_flops": state["cfg"]["precision"]}
    return run


def tail(state) -> None:
    """After the window: its next step through the same call and feed,
    from the window's state; the state before and after it, the model's
    input and the encoder's CLS states kept for the check."""
    task = state["task"]
    batch = next(state["batches"])
    params = dict(task.model.named_parameters())
    before = common.snapshot(params)
    moments = common.adam_state(task.optimizer.inner, params)
    cap = _Capture(task.model)
    loss = task.train_step(batch)["loss"]
    common.sync(state["device"])
    rec = _record(batch, loss)
    rec.update(cap.close()[0])
    rec.update(before=before, moments=moments, after=common.snapshot(params),
               m_after=common.adam_state(task.optimizer.inner, params)[0])
    state["tail"] = rec


def release(state) -> None:
    state.pop("task", None)
    state.pop("batches", None)


def check(state) -> list:
    """The plain reference over the three checked steps from the seed's
    weights and over the step after the window from the program's state;
    every checked step's input held to its feed, its negatives to the
    training positives and its contexts to the sampler's guarantees; every
    leaf moved over the window."""
    cfg, raw, steps, tail = state["cfg"], state["raw"], state["steps"], state["tail"]
    dev = state["device"]
    pos = pc.positives(state["train_pairs"])
    neg_bad = ctx_bad = feed_bad = 0
    adj = sampler.adjacency(raw.num_nodes, raw.edges, dev)
    for rec in steps + [tail]:
        feed_bad += common.mismatch(rec["model_users"], rec["users"])
        feed_bad += common.mismatch(rec["seq_ids"][:, 0], rec["items"] + 2)
        neg_bad += sampler.negative_violations(rec["users"].tolist(), rec["items"].tolist(),
                                               rec["labels"].tolist(), pos)
        ctx_bad += sampler.context_violations(adj, rec["seq_ids"], rec["seq_mask"],
                                              rec["items"] + 2, len(cfg["hop_sampling_sizes"]))
    got = {"losses": [r["loss"] for r in steps], "grad": steps[0]["grad"],
           "params": steps[-1]["params"], "cls": [r["cls"] for r in steps]}
    ref = reference_steps(state, "f32", dev)
    gaps = _gaps(got, ref)
    tail_got = common.tail_of_program(tail)
    tail_got["cls"] = [tail["cls"]]
    gaps.update(_tail_gaps(tail_got, reference_tail(state, "f32", dev), tail["before"]))
    gaps["window_unmoved"] = common.unmoved(state["setup_params"], tail["before"], ref["grad"])
    state["readings"] = gaps
    return [common.check("feed_violations", feed_bad, 0),
            common.check("sampler_violations", neg_bad + ctx_bad, 0),
            common.check("window_unmoved", gaps["window_unmoved"], 0)] + [
        common.check(n, gaps[n], limit) for n, limit in cfg["limits"].items() if n in gaps]


def _cls_gap(got, ref) -> float:
    """The widest relative gap, over the steps, between the encoder's CLS
    states of the step's items (Frobenius norm) and the reference's."""
    return max(float(torch.linalg.norm(a.cpu()[:len(b)] - b.cpu()[:len(a)])
                     / torch.linalg.norm(b.cpu()[:len(a)]).clamp(min=1e-30))
               for a, b in zip(got, ref))


def _gaps(got: dict, ref: dict) -> dict:
    """The training numbers, and ``cls_gap`` of the checked steps."""
    out = common.train_gaps(got, ref)
    out["cls_gap"] = _cls_gap(got["cls"], ref["cls"])
    return out


def _tail_gaps(got: dict, ref: dict, before: dict) -> dict:
    out = common.tail_gaps(got, ref, before)
    out["tail_cls_gap"] = _cls_gap(got["cls"], ref["cls"])
    return out


def control(state, precision: str, dev, fault=None) -> dict:
    """The reference in ``precision`` (or with ``fault`` planted) put in
    the program's place: its numbers against the f32 reference."""
    out = _gaps(reference_steps(state, precision, dev, fault), reference_steps(state, "f32", dev))
    out.update(_tail_gaps(reference_tail(state, precision, dev, fault),
                          reference_tail(state, "f32", dev), state["tail"]["before"]))
    return out


def _follow(state, w: dict, opt, recs, precision: str, dev, fault=None) -> dict:
    """The reference's steps over ``recs`` from weights ``w`` and ``opt``:
    each step's loss and CLS states, the first step's gradient as the
    update took it, the weights after the last."""
    cfg = state["cfg"]
    plain.set_f32_matmul()
    ar = plain.Arith(precision)
    tables = pc.feats(state, dev)
    for t in w.values():
        t.requires_grad_(True)
    losses, first, all_cls = [], None, []
    names = list(w)
    for rec in recs:
        batch = {k: rec[k].to(dev) for k in ("users", "items", "labels", "seq_ids", "seq_mask")}
        batch["users"], batch["items"] = batch["users"].long(), batch["items"].long()
        if fault == "half_batch":  # half the examples left out, the mean over the rest
            batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        logits, cls = plain.pmgt_ncf_logits(w, cfg, ar, tables, batch, plain.Draws(rec["seed"], dev))
        loss = plain.bce(logits, batch["labels"]).mean()
        all_cls.append(cls.detach().cpu())
        grads = opt.clipped(dict(zip(names, torch.autograd.grad(loss, [w[n] for n in names]))))
        if first is None:
            first = {n: g.detach().cpu() for n, g in grads.items()}
        losses.append(float(loss.detach()))
        opt.step(w, grads)
    return {"losses": losses, "grad": first, "cls": all_cls,
            "params": {n: t.detach().cpu() for n, t in w.items()}}


def reference_steps(state, precision: str, dev, fault=None) -> dict:
    """The reference's losses, CLS states, first gradient and parameters
    after the checked steps, from the seed's weights."""
    cfg = state["cfg"]
    w = pc.reference_weights(state, dev)
    w0 = {n: t.detach().cpu().clone() for n, t in w.items()}
    opt = plain.AdamW(w, cfg["lr"], cfg["decay"], cfg["gradient_max_norm"])
    out = _follow(state, w, opt, state["steps"], precision, dev, fault)
    out["w0"] = w0
    return out


def reference_tail(state, precision: str, dev, fault=None) -> dict:
    """The reference's step after the window, from the program's weights
    and optimizer state before it: {"loss", "grad", "after", "cls"}."""
    w, opt = common.resume(state["tail"], state["cfg"], dev)
    out = _follow(state, w, opt, [state["tail"]], precision, dev, fault)
    return {"loss": out["losses"][0], "grad": out["grad"], "after": out["params"],
            "cls": out["cls"]}
