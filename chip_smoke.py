"""Smoke test of the PyTorch/CUDA port on one GPU: builds the kernels,
holds each against its plain PyTorch version, drives the serving path and
the training path, and checks what comes out.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. The card's name and power limit (``nvidia-smi``), then the kernel build
   (one ``nvcc`` per source, all started together) and its time.
2. K1, the seq-major dual-attention forward, against
   ``dual_attention_sm_reference`` at the serving shapes S=6, d=128,
   N=768 (eval: 256 targets + 512 pair lanes) and N=256 (export), in f32
   and bf16, with and without keep masks. Tolerance: max abs error
   <= 1e-5 in f32, <= 2e-2 of the output's max magnitude in bf16. Device
   times from CUDA-graph replay (mean over many launches, inputs warm in
   L2), and CUDA-event times of back-to-back eager calls beside them.
3. The main path at full width: the default PMGT model (hidden 128, 5
   layers, feature widths 1536/768, hops 16/8/4, test batch 256) with
   random weights from seed 0, on the TG-shape synthetic dataset (10,834
   nodes, 38,252 edges). ``PMGTTask.evaluate`` (val pair-AUC) and
   ``PMGTTask.export_embeddings``. The launch counts are zeroed just
   before and read just after; K1 must run 5 times per encoder call.
4. The check: the same evaluation and export with the attention forced
   to the plain batch-major PyTorch version, on the same contexts and
   weights. AUC within 1e-5, embeddings within 1e-4; export [10834, 128]
   and finite.

5. K2, the seq-major dual-attention backward, against
   ``dual_attention_sm_backward_reference`` at S=6, d=128, N=3072 (the
   training lanes: 256 targets + 2,560 pair lanes + 256 masked lanes) and
   N=37 (ragged), f32, with and without keep masks, some keys masked in
   every sequence and one zero context row. Tolerance: each of dq, dk, dv,
   dc within 1e-5 * max(1, max|ref|); dc of the sequences without the
   zero row is also held to 1e-5 * max(1, their max|ref|) (the zero row's
   dc is of order 1e12, the derivative of the clamped cosine). K1 is also
   checked at N=3072. Device times from CUDA-graph replay.
6. The training path at full width, from the seed-0 weights on the kernel
   route: evaluate, one epoch of ``train_epoch`` (8,667 train nodes: 33
   steps of 256, dropout on, GSR + NFR, AdamW), evaluate again. Every loss
   finite, the mean loss of the last 5 steps below that of the first 5,
   and K1 == K2 == 5 launches per micro-step over the epoch (the counts
   zeroed just before and read just after; serving launches no K2).
7. The kernel route against the plain route in training: fresh tasks from
   the same weights and per-step generators, 3 steps each. Step-1
   gradients of every parameter within 1e-4 * max|g| of that parameter,
   losses within 1e-4 relative; the plain route launches neither kernel.

After each counted run, one pass under ``torch.profiler`` (one evaluate
and one export; one training step) gives the device's busy time (summed
kernel time) against the host wall time, and K1's and K2's parts of it.

Float32 matmuls run in full f32 (TF32 off) on both paths. Detailed
results also go to ``outputs/chip_smoke.json``. The last line of
standard output is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores

K1_SOURCE = "pmgt_tpu_torch/ops/csrc/dual_attention_fwd.cu"
K1_REPLACES = "pmgt_tpu/ops/dual_attention.py:381"  # _pallas_forward_sm
K2_SOURCE = "pmgt_tpu_torch/ops/csrc/dual_attention_bwd.cu"
K2_REPLACES = "pmgt_tpu/ops/dual_attention.py:444"  # _pallas_backward_sm
KERNEL_NAMES = {"k1": "dual_attention_fwd_sm_kernel",
                "k2": "dual_attention_bwd_kernel"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """Mean time of ``fn()`` in ms between CUDA events around ``iters``
    back-to-back calls. Where the host issues calls more slowly than the
    card runs them, this is the host's issue rate, not device time."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 50, reps: int = 5) -> float:
    """Device time per call of ``fn()`` in ms: ``iters`` calls captured in
    one CUDA graph, replayed ``reps`` times between CUDA events. The
    replay issues the kernels back to back, so the host's Python cost per
    call drops out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def profile_phases(phases) -> dict:
    """One ``torch.profiler`` session over ``phases`` ((name, fn) pairs,
    each ending in a host sync). Per phase: the host wall time, the summed
    duration of the device kernels that started inside it (one stream,
    so they do not overlap), their count, and K1's and K2's parts. Returns
    {} when the profiler saw no device kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for name, fn in phases:
            with record_function(f"phase:{name}"):
                fn()
    events = prof.events()
    ranges = {e.name[len("phase:"):]: e.time_range for e in events
              if e.name.startswith("phase:")}
    # The phase annotations also appear on the device timeline: skip them.
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.name.startswith("phase:")]
    if not kernels:
        return {}
    out = {}
    for name, rng in ranges.items():
        mine = [e for e in kernels if rng.start <= e.time_range.start <= rng.end]
        busy = sum(e.time_range.elapsed_us() for e in mine) / 1e3
        by_name = {}
        for e in mine:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        wall = rng.elapsed_us() / 1e3
        out[name] = {
            "wall_ms": wall,
            "device_busy_ms": busy,
            "device_busy_share": busy / wall,
            "kernel_launches": len(mine),
            "top_kernels": sorted(by_name.items(), key=lambda x: -x[1])[:6],
        }
        for key, kname in KERNEL_NAMES.items():
            ks = [e for e in mine if kname in e.name]
            out[name][f"{key}_launches"] = len(ks)
            out[name][f"{key}_device_ms"] = sum(
                e.time_range.elapsed_us() for e in ks) / 1e3
    return out


def k1_bound_ms(s: int, n: int, d: int, elem_bytes: int, mask_bytes: int) -> dict:
    """Least time for one K1 call on an H100: each input read once and the
    output written once (q, k, v, c, out; the [N, S] f32 additive mask;
    the two [S, N, S] keep masks when given), against the f32 work
    (c·cᵀ, q·kᵀ and P·v: 6·S²·N·d operations, plus the S norms)."""
    nbytes = 5 * s * n * d * elem_bytes + 4 * n * s + 2 * s * n * s * mask_bytes
    flops = 6 * s * s * n * d + 2 * s * n * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return {
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes,
        "flops": flops,
    }


def check_k1(s: int, n: int, d: int, dtype, keep_masks: bool) -> dict:
    """K1 against its plain version on one input; returns errors, times."""
    import torch

    from pmgt_tpu_torch.ops.dual_attention import (
        dual_attention_sm,
        dual_attention_sm_reference,
    )

    g = torch.Generator(device="cuda").manual_seed(s * 100_003 + n)
    q, k, v, c = (
        torch.randn(s, n, d, generator=g, device="cuda").to(dtype)
        for _ in range(4)
    )
    mask = torch.zeros(n, s, device="cuda")
    n_ctx = torch.randint(0, s, (n,), generator=g, device="cuda")
    keys = torch.arange(s, device="cuda")
    mask[keys[None, :] > n_ctx[:, None]] = torch.finfo(torch.float32).min
    m1 = m2 = None
    if keep_masks:
        m1 = torch.rand(s, n, s, generator=g, device="cuda") < 0.9
        m2 = torch.rand(s, n, s, generator=g, device="cuda") < 0.9
    args = (q, k, v, c, mask, m1, m2, 0.5, 0.9, keep_masks)

    out = dual_attention_sm(*args)
    torch.cuda.synchronize()
    ref = dual_attention_sm_reference(
        q.float(), k.float(), v.float(), c.float(), *args[4:]
    )
    if out.shape != ref.shape or not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"K1 output malformed at S={s} N={n} d={d} {dtype}")
    err = (out.float() - ref).abs().max().item()
    scale = ref.abs().max().item()
    if dtype == torch.float32:
        ok, tol = err <= 1e-5, "max abs err <= 1e-5"
    else:
        ok, tol = err <= 2e-2 * scale, "max abs err <= 2e-2 * max|out|"
    row = {
        "phase": "k1_check", "S": s, "N": n, "d": d,
        "dtype": str(dtype).replace("torch.", ""), "keep_masks": keep_masks,
        "max_abs_err": err, "max_abs_out": scale, "tolerance": tol, "ok": ok,
        # Device time from CUDA-graph replay; the events time of
        # back-to-back eager calls is kept beside it (the host's issue
        # rate where the wrapper's Python costs more than the kernel).
        "ms": graph_ms(lambda: dual_attention_sm(*args)),
        "plain_ms": graph_ms(lambda: dual_attention_sm_reference(*args)),
        "wrapper_events_ms": cuda_ms(lambda: dual_attention_sm(*args)),
        "plain_events_ms": cuda_ms(lambda: dual_attention_sm_reference(*args),
                                   iters=50),
    }
    row.update(k1_bound_ms(s, n, d, q.element_size(), 1 if keep_masks else 0))
    emit(row)
    if not ok:
        raise RuntimeError(f"K1 disagrees with its plain version: {row}")
    return row


def k2_bound_ms(s: int, n: int, d: int, elem_bytes: int, mask_bytes: int) -> dict:
    """Least time for one K2 call on an H100: reads q, k, v, c, g, the
    [N, S] f32 mask and the two [S, N, S] keep masks when given, writes dq,
    dk, dv, dc; against the f32 work of its seven S x S x d products (c·cᵀ,
    q·kᵀ, g·vᵀ, probsᵀ·g, dS2·k, dS2ᵀ·q, A·c: 14·S²·N·d operations, plus
    the S norms)."""
    nbytes = (9 * s * n * d * elem_bytes + 4 * n * s
              + 2 * s * n * s * mask_bytes)
    flops = 14 * s * s * n * d + 2 * s * n * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return {
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes,
        "flops": flops,
    }


def check_k2(s: int, n: int, d: int, keep_masks: bool) -> dict:
    """K2 against its plain version on one f32 input (masked keys in
    every sequence, one zero context row); returns errors and times."""
    import torch

    from pmgt_tpu_torch.ops.dual_attention import (
        dual_attention_sm_backward,
        dual_attention_sm_backward_reference,
    )

    g = torch.Generator(device="cuda").manual_seed(s * 7_919 + n)
    q, k, v, c, go = (torch.randn(s, n, d, generator=g, device="cuda")
                      for _ in range(5))
    zero_seq = n // 2
    c[s - 1, zero_seq] = 0.0  # a zero context row
    mask = torch.zeros(n, s, device="cuda")
    n_ctx = torch.randint(0, s, (n,), generator=g, device="cuda")
    keys = torch.arange(s, device="cuda")
    mask[keys[None, :] > n_ctx[:, None]] = torch.finfo(torch.float32).min
    m1 = m2 = None
    if keep_masks:
        m1 = torch.rand(s, n, s, generator=g, device="cuda") < 0.9
        m2 = torch.rand(s, n, s, generator=g, device="cuda") < 0.9
    args = (q, k, v, c, mask, m1, m2, go, 0.5, 0.9, keep_masks)

    got = dual_attention_sm_backward(*args)
    torch.cuda.synchronize()
    want = dual_attention_sm_backward_reference(*args)
    errs, oks = {}, []
    for name, a, b in zip(("dq", "dk", "dv", "dc"), got, want):
        if a.shape != b.shape or not bool(torch.isfinite(a).all()):
            raise RuntimeError(f"K2 {name} malformed at S={s} N={n} d={d}")
        err = (a - b).abs().max().item()
        tol = 1e-5 * max(1.0, b.abs().max().item())
        errs[name] = {"max_abs_err": err, "max_abs_ref": b.abs().max().item(),
                      "limit": tol}
        oks.append(err <= tol)
    others = torch.ones(n, dtype=torch.bool, device="cuda")
    others[zero_seq] = False
    a, b = got[3][:, others], want[3][:, others]
    err = (a - b).abs().max().item()
    tol = 1e-5 * max(1.0, b.abs().max().item())
    errs["dc_without_zero_row"] = {"max_abs_err": err,
                                   "max_abs_ref": b.abs().max().item(),
                                   "limit": tol}
    oks.append(err <= tol)
    row = {
        "phase": "k2_check", "S": s, "N": n, "d": d, "dtype": "float32",
        "keep_masks": keep_masks, "errors": errs,
        # the largest error among the gradients without the zero row's dc
        "max_abs_err": max(errs[x]["max_abs_err"]
                           for x in ("dq", "dk", "dv", "dc_without_zero_row")),
        "tolerance": "each gradient max abs err <= 1e-5 * max(1, max|ref|)",
        "ok": all(oks),
        "ms": graph_ms(lambda: dual_attention_sm_backward(*args)),
        "plain_ms": graph_ms(lambda: dual_attention_sm_backward_reference(*args)),
    }
    row.update(k2_bound_ms(s, n, d, 4, 1 if keep_masks else 0))
    emit(row)
    if not row["ok"]:
        raise RuntimeError(f"K2 disagrees with its plain version: {row}")
    return row


def run_slice(task, label: str) -> dict:
    """Evaluate and export through ``task``; returns metrics, embeddings,
    times and the K1 launches of the run."""
    import torch

    from pmgt_tpu_torch.ops.dual_attention import (
        dual_attention_sm,
        dual_attention_sm_backward,
    )

    t0 = time.perf_counter()
    for tag in (("valid",), ("inference",)):
        task._get_ctx(tag)
    torch.cuda.synchronize()
    ctx_s = time.perf_counter() - t0
    # One untimed, uncounted pass first (library handles, allocator).
    task.evaluate("valid")
    task.export_embeddings()
    torch.cuda.synchronize()

    dual_attention_sm.launches = dual_attention_sm_backward.launches = 0
    t0 = time.perf_counter()
    metrics = task.evaluate("valid")
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    emb = task.export_embeddings()
    torch.cuda.synchronize()
    export_s = time.perf_counter() - t0
    launches = dual_attention_sm.launches
    k2_launches = dual_attention_sm_backward.launches

    # Where the time goes: one profiled evaluate and export (not counted).
    busy = profile_phases((("evaluate", lambda: task.evaluate("valid")),
                           ("export", task.export_embeddings)))

    bs = task.args.test_batch_size
    encoder_calls = math.ceil(len(task.valid_nodes) / bs) + math.ceil(
        task.artifacts.num_nodes / bs
    )
    out = {
        "phase": f"slice_{label}",
        "attention_impl": task.config.attention_impl,
        "phase_ctx_draw_ms": ctx_s * 1e3,
        "evaluate_ms": eval_s * 1e3,
        "export_ms": export_s * 1e3,
        **metrics,
        "export_shape": list(emb.shape),
        "export_finite": bool(np.isfinite(emb).all()),
        "encoder_calls": encoder_calls,
        "k1_launches": launches,
        "k2_launches": k2_launches,
        "profiled": busy or "not measured: the profiler saw no device kernel",
    }
    emit(out)
    return {"row": out, "emb": emb, "metrics": metrics}


def run_training(task) -> dict:
    """Evaluate, one counted and timed epoch of ``train_epoch``, evaluate
    again, then one profiled step; raises unless every loss is finite, the
    loss falls and K1 == K2 == 5 launches per micro-step."""
    import torch

    from pmgt_tpu_torch.ops.dual_attention import (
        dual_attention_sm,
        dual_attention_sm_backward,
    )

    before = task.evaluate("valid")
    t0 = time.perf_counter()
    task.on_epoch_start(0)
    torch.cuda.synchronize()
    ctx_ms = (time.perf_counter() - t0) * 1e3

    dual_attention_sm.launches = dual_attention_sm_backward.launches = 0
    t0 = time.perf_counter()
    losses = task.train_epoch(0)
    torch.cuda.synchronize()
    epoch_ms = (time.perf_counter() - t0) * 1e3
    k1, k2 = dual_attention_sm.launches, dual_attention_sm_backward.launches

    losses = losses.cpu().numpy()
    after = task.evaluate("valid")
    steps = len(losses)
    micro = steps * task.args.accumulation_step
    layers = task.config.num_hidden_layers

    # One steady-state step, synchronized, then one under the profiler.
    batches = task.train_batches(1)
    task.on_epoch_start(1)
    batch = next(batches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    task.train_step(batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    batch = next(batches)
    busy = profile_phases(
        (("train_step", lambda: (task.train_step(batch), torch.cuda.synchronize())),)
    )

    first, last = float(losses[:5].mean()), float(losses[-5:].mean())
    row = {
        "phase": "train",
        "attention_impl": task.config.attention_impl,
        "train_batch_size": task.args.train_batch_size,
        "lanes_per_micro_step": task.args.train_batch_size // task.args.accumulation_step
        * (2 + task.sampling.max_total_samples),
        "steps": steps,
        "train_ctx_draw_ms": ctx_ms,
        "epoch_ms": epoch_ms,
        "mean_step_ms": epoch_ms / max(steps, 1),
        "steady_step_ms": step_ms,
        "losses": losses.tolist(),
        "loss_first5": first,
        "loss_last5": last,
        "losses_finite": bool(np.isfinite(losses).all()),
        "eval_before": before,
        "eval_after": after,
        "k1_launches": k1,
        "k2_launches": k2,
        "expected_launches": layers * micro,
        "profiled": busy or "not measured: the profiler saw no device kernel",
    }
    emit(row)
    if steps == 0 or not row["losses_finite"] or not last < first:
        raise RuntimeError(f"training did not run, diverged or did not learn: {row}")
    if k1 != layers * micro or k2 != layers * micro:
        raise RuntimeError(f"K1/K2 launched {k1}/{k2} times, expected "
                           f"{layers * micro} each")
    return row


def compare_training_routes(make_task) -> dict:
    """Three steps on the kernel route and on the plain route from the same
    weights, training draw and per-step generators. Step-1 gradients within
    1e-4 * max|g| + 1e-8 per parameter (the floor is for the key biases,
    whose gradient is zero up to rounding: a softmax ignores a constant
    added to every key's score), losses within 1e-4 relative; the plain
    route launches no kernel. A fourth step of each route runs under the
    profiler (not counted)."""
    import torch

    from pmgt_tpu_torch.ops.dual_attention import (
        dual_attention_sm,
        dual_attention_sm_backward,
    )

    kern, plain = make_task("pallas"), make_task("xla")
    plain.model.load_state_dict(kern.model.state_dict())
    kern.on_epoch_start(0)
    plain._train_ctx, plain._train_ctx_tag = kern._train_ctx, kern._train_ctx_tag
    launches, losses, grads, busy = {}, {}, {}, {}
    for name, task in (("kernel", kern), ("plain", plain)):
        dual_attention_sm.launches = dual_attention_sm_backward.launches = 0
        batches = list(task.train_batches(0))[:4]
        out = []
        for i, (targets, gen) in enumerate(batches[:3]):
            metrics = task.accumulate_gradients(targets, gen)
            if i == 0:
                grads[name] = {n: p.grad.detach().clone()
                               for n, p in task.model.named_parameters()}
            task.optimizer.step()
            out.append(metrics["loss"])
        losses[name] = torch.stack(out).cpu().numpy()
        torch.cuda.synchronize()
        launches[name] = (dual_attention_sm.launches,
                          dual_attention_sm_backward.launches)
        busy[name] = profile_phases((("train_step", lambda: (
            task.train_step(batches[3]), torch.cuda.synchronize())),))
    worst_grad, worst_excess = 0.0, 0.0
    for n, gk in grads["kernel"].items():
        gp = grads["plain"][n]
        err, scale = (gk - gp).abs().max().item(), gp.abs().max().item()
        worst_excess = max(worst_excess, err / (1e-4 * scale + 1e-8))
        if scale > 1e-6:
            worst_grad = max(worst_grad, err / scale)
    loss_rel = float(np.max(np.abs(losses["kernel"] - losses["plain"])
                            / np.abs(losses["plain"])))
    ok = (worst_excess <= 1.0 and loss_rel <= 1e-4
          and launches["plain"] == (0, 0) and min(launches["kernel"]) > 0)
    row = {
        "phase": "train_route_check",
        "losses_kernel": losses["kernel"].tolist(),
        "losses_plain": losses["plain"].tolist(),
        "loss_max_rel_diff": loss_rel,
        "step1_grad_max_diff_over_max_abs_grad": worst_grad,  # max|g| > 1e-6
        "step1_grad_err_over_limit": worst_excess,
        "launches_kernel_route": launches["kernel"],
        "launches_plain_route": launches["plain"],
        "profiled_kernel_route": busy["kernel"] or "not measured",
        "profiled_plain_route": busy["plain"] or "not measured",
        "ok": ok,
    }
    emit(row)
    if not ok:
        raise RuntimeError("kernel route and plain route train differently")
    return row


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "pmgt_tpu_torch")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the port's kernels need a GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}

    # ---- 1. card and build ---------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "card", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    results["card"] = smi

    from pmgt_tpu_torch.ops import build

    t0 = time.perf_counter()
    build.build_all()
    emit({"phase": "build", "kernels": list(build.KERNELS),
          "seconds": time.perf_counter() - t0})

    # ---- 2. K1 against its plain version --------------------------------
    checks = [
        check_k1(6, n, 128, dt, km)
        for n in (768, 256)
        for dt in (torch.float32, torch.bfloat16)
        for km in (False, True)
    ]
    # K1 at the training lanes (256 targets + 2,560 pairs + 256 masked)
    checks += [check_k1(6, 3072, 128, torch.float32, km) for km in (False, True)]
    results["k1_checks"] = checks

    # ---- 5. K2 against its plain version --------------------------------
    k2_checks = [check_k2(6, n, 128, km) for n in (3072, 37) for km in (False, True)]
    results["k2_checks"] = k2_checks

    # ---- 3. main path: evaluate + export at full width ------------------
    from pmgt_tpu_torch.core.config import TrainArgs
    from pmgt_tpu_torch.data.synthetic import make_published_shape_dataset
    from pmgt_tpu_torch.ops.dual_attention import dual_attention_sm
    from pmgt_tpu_torch.tasks.pmgt_task import PMGTTask, init_dataloader

    t0 = time.perf_counter()
    art = make_published_shape_dataset("TG", seed=0)
    data_s = time.perf_counter() - t0
    args = TrainArgs(seed=0, test_batch_size=256)
    ctx = {"artifacts": art}
    init_dataloader(args, ctx)
    emit({"phase": "data", "dataset": "TG-shape synthetic",
          "num_nodes": art.num_nodes,
          "num_edges": int(art.graph.degrees.sum()) // 2,
          "max_degree": art.graph.max_degree,
          "valid_nodes": len(ctx["valid_nodes"]),
          "dataset_and_alias_build_s": data_s})

    task = PMGTTask(args, art, ctx["train_nodes"], ctx["valid_nodes"])
    from pmgt_tpu_torch.sampling.pairs import sample_all_contexts

    gen = torch.Generator(device="cuda").manual_seed(1)
    sample_all_contexts(task.graph, task.sampling, task.sampling.num_total, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sample_all_contexts(task.graph, task.sampling, task.sampling.num_total, gen)
    torch.cuda.synchronize()
    emit({"phase": "sample_all_contexts", "rows": task.sampling.num_total,
          "ms": (time.perf_counter() - t0) * 1e3})

    kern = run_slice(task, "kernel")
    n_launches = kern["row"]["k1_launches"]
    want = 5 * kern["row"]["encoder_calls"]
    serving_ok = n_launches == want and kern["row"]["k2_launches"] == 0
    emit({"phase": "k1_launches", "launches": n_launches,
          "k2_launches": kern["row"]["k2_launches"],
          "expected": want, "ok": serving_ok})
    if not serving_ok:
        raise RuntimeError(f"serving launched K1 {n_launches} times (expected "
                           f"{want}) and K2 {kern['row']['k2_launches']} times")
    if kern["emb"].shape != (art.num_nodes, 128) or not kern["row"]["export_finite"]:
        raise RuntimeError(f"bad export: {kern['row']}")

    # ---- 4. the same path with the plain attention ----------------------
    plain_args = TrainArgs(seed=0, test_batch_size=256,
                           extra={"attention_impl": "xla"})
    plain = PMGTTask(plain_args, art, ctx["train_nodes"], ctx["valid_nodes"])
    plain.model.load_state_dict(task.model.state_dict())
    plain._phase_ctx_cache = dict(task._phase_ctx_cache)
    ref = run_slice(plain, "plain")
    if ref["row"]["k1_launches"] != 0:
        raise RuntimeError("the plain path launched K1")
    auc_diff = abs(kern["metrics"]["val/auc"] - ref["metrics"]["val/auc"])
    loss_diff = abs(kern["metrics"]["val/loss"] - ref["metrics"]["val/loss"])
    emb_diff = float(np.abs(kern["emb"] - ref["emb"]).max())
    agree = auc_diff <= 1e-5 and emb_diff <= 1e-4
    emit({"phase": "check", "auc_diff": auc_diff, "loss_diff": loss_diff,
          "export_max_abs_diff": emb_diff, "ok": agree})
    if not agree:
        raise RuntimeError("kernel path and plain path disagree")

    # ---- 6. the training path at full width ---------------------------
    train = run_training(task)

    # ---- 7. kernel route against plain route in training ---------------
    def make_task(impl):
        a = TrainArgs(seed=0, test_batch_size=256, extra={"attention_impl": impl})
        return PMGTTask(a, art, ctx["train_nodes"], ctx["valid_nodes"])

    routes = compare_training_routes(make_task)

    # ---- summary ---------------------------------------------------------
    # Both kernels at the training lanes with keep masks (dropout is on in
    # training); launches over the counted serving and training runs.
    k1_row = next(r for r in checks if r["N"] == 3072 and r["keep_masks"])
    k2_row = next(r for r in k2_checks if r["N"] == 3072 and r["keep_masks"])
    kernels = []
    for name, source, replaces, row, rows, launches in (
        ("dual_attention_fwd_sm", K1_SOURCE, K1_REPLACES, k1_row,
         [r for r in checks if r["dtype"] == "float32"],
         {"serving": n_launches, "training": train["k1_launches"]}),
        ("dual_attention_bwd_sm", K2_SOURCE, K2_REPLACES, k2_row, k2_checks,
         {"serving": kern["row"]["k2_launches"], "training": train["k2_launches"]}),
    ):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,  # no single PyTorch call computes it
        })
    results.update(kernels=kernels, slice_kernel=kern["row"],
                   slice_plain=ref["row"], train=train, train_routes=routes)
    os.makedirs(os.path.join(HERE, "outputs"), exist_ok=True)
    with open(os.path.join(HERE, "outputs", "chip_smoke.json"), "w") as f:
        json.dump(results, f, indent=1)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
