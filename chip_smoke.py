"""Smoke test of the PyTorch/CUDA port on one GPU: builds the kernels,
holds each against its plain PyTorch version, drives the serving path and
the training path, and checks what comes out.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. The card's name and power limit (``nvidia-smi``), then the kernel build
   (one ``nvcc`` per source, all started together), its time, and each
   kernel instance's registers, stack and spills from the ptxas report.
2. K1, the seq-major dual-attention forward, against
   ``dual_attention_sm_reference`` at the serving shapes S=6, d=128,
   N=768 (eval: 256 targets + 512 pair lanes) and N=256 (export), in f32
   and bf16, with and without keep masks. Tolerance: max abs error
   <= 1e-5 in f32, <= 2e-2 of the output's max magnitude in bf16. Device
   times from CUDA-graph replay (mean over many launches, inputs warm in
   L2: ``ms``; each launch after a 128 MB read that evicts the L2, the
   read's own time taken away: ``cold_ms``), and CUDA-event times of
   back-to-back eager calls beside them.
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
   N=768, N=256 and N=37 (ragged), f32, with and without keep masks, some
   keys masked in every sequence and one zero context row. Tolerance: each
   of dq, dk, dv,
   dc within 1e-5 * max(1, max|ref|); dc of the sequences without the
   zero row is also held to 1e-5 * max(1, their max|ref|) (the zero row's
   dc is of order 1e12, the derivative of the clamped cosine). K1 is also
   checked at N=3072. Device times (warm and cold L2) from CUDA-graph
   replay.
5b. An untimed sweep of K1 (f32, bf16), K2, K3 (f32, bf16) and K4 against
   their plain versions over N in {1, 37, 3071}, S in {1, 2, 8, 9, 32} and
   d in {32, 96, 256}: ragged tiles, one-key rows, 32-lane key groups, the
   largest tile (one stage). Some sequences have every key masked but one;
   the keep masks cycle through none, bool and f32. Tolerances as above.
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

8. K3 and K4, the batch-major kernels (K1's and K2's kernels on
   batch-major strides), through the public op ``dual_attention_pallas``
   and ``DualAttentionBm`` against the plain batch-major versions: B·h =
   3072 and 768 (h = 1, S = 6, d = 128) in f32 and, for K3, bf16, with and
   without keep masks; a ragged B·h = 37; h = 2, d = 64. Tolerances as K1
   and K2: 1e-5 * max(1, max|ref|) in f32 (each gradient), 2e-2 * max|out|
   in bf16. Device times (warm and cold L2) from CUDA-graph replay.
9. The two layouts on real tensors: q/k/v/c of the encoder's first layer on
   a 768-lane validation chunk; K1 seq-major against K3 on the same tensors
   as [B, h, S, d], K2 against K4, within 1e-6 * max(1, max|out|). Then the
   batch-major path: ``dual_attention_pallas`` forward (dropout on) and its
   autograd backward, 3 calls, counts zeroed just before and read just
   after: K3 == K4 == 3.
10. ``train-pmgt`` end to end through the port's CLI (``main()`` in this
    process) on the TG-shape data written with ``save_native``, default
    model: 2 epochs (FINISHED, two ``val/auc`` rows, ``best.json``,
    ``best/`` and ``last/``), a resume with ``--num-epochs 3`` (one epoch,
    global step 99), ``--mode eval`` (finite test metrics, status
    untouched), ``best`` restored here reproducing its logged ``val/auc``
    within 1e-6, and ``--mode inference`` ([10834, 128] float32, finite).
    Launches per invocation: K2 5 per step, K1 as many plus 5 per
    evaluation chunk. Checkpoint save, resume and export times.

After the serving and training runs, one pass under ``torch.profiler``
(one evaluate and one export; one training step) gives the device's busy
time (summed kernel time) against the host wall time, and K1's and K2's
parts of it. The later phases open no profiler session.

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
K3_REPLACES = "pmgt_tpu/ops/dual_attention.py:100"  # _pallas_forward
K4_REPLACES = "pmgt_tpu/ops/dual_attention.py:246"  # _pallas_backward
# Kernel symbols in profiles. K3 is K1's kernel on batch-major strides and
# K4 is K2's; the profiled phases run only the seq-major ones.
KERNEL_NAMES = {"k1": "dual_attention_fwd_kernel",
                "k2": "dual_attention_bwd_kernel"}


def _counters():
    """The four kernels' launch counters: K1, K2, K3, K4."""
    from pmgt_tpu_torch.ops import dual_attention as da

    return (da.dual_attention_sm, da.dual_attention_sm_backward,
            da.dual_attention_bm_forward, da.dual_attention_bm_backward)


def zero_launches() -> None:
    for c in _counters():
        c.launches = 0


def read_launches() -> dict:
    return dict(zip(("k1", "k2", "k3", "k4"), (c.launches for c in _counters())))


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


_FLUSH = {}


def cold_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device time per call of ``fn()`` in ms with a cold L2: as
    ``graph_ms``, but each call follows a read of a 128 MB buffer (more
    than the 50 MB L2), and the time of the reads alone is taken away. A
    read and not a write: a write would leave the L2 full of dirty lines
    whose write-back the timed kernel would pay for."""
    import torch

    if not _FLUSH:
        _FLUSH["buf"] = torch.ones(32 << 20, device="cuda")  # 128 MB
        _FLUSH["out"] = torch.empty((), device="cuda")

    def flush():
        torch.sum(_FLUSH["buf"], dim=0, out=_FLUSH["out"])

    both = graph_ms(lambda: (flush(), fn()), iters, reps)
    return both - graph_ms(flush, iters, reps)


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
        "cold_ms": cold_ms(lambda: dual_attention_sm(*args)),
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
        "cold_ms": cold_ms(lambda: dual_attention_sm_backward(*args)),
        "plain_ms": graph_ms(lambda: dual_attention_sm_backward_reference(*args)),
    }
    row.update(k2_bound_ms(s, n, d, 4, 1 if keep_masks else 0))
    emit(row)
    if not row["ok"]:
        raise RuntimeError(f"K2 disagrees with its plain version: {row}")
    return row


def _bm_inputs(b: int, h: int, s: int, d: int, dtype, seed: int):
    """q, k, v, c, g [B, h, S, d] on the card; the additive mask
    [B, 1, 1, S] with masked keys in every sequence; one zero context row
    (sequence ``zero_seq`` of the folded [B·h, S, d])."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, c, go = (torch.randn(b, h, s, d, generator=g, device="cuda").to(dtype)
                      for _ in range(5))
    zero_seq = (b * h) // 2
    c.view(b * h, s, d)[zero_seq, s - 1] = 0.0
    mask = torch.zeros(b, 1, 1, s, device="cuda")
    n_ctx = torch.randint(0, s, (b,), generator=g, device="cuda")
    keys = torch.arange(s, device="cuda")
    mask[(keys[None, :] > n_ctx[:, None])[:, None, None, :]] = torch.finfo(torch.float32).min
    return q, k, v, c, go, mask, zero_seq


def _draw_bm_masks(n: int, s: int, seed: int):
    """m1 then m2 [N, S, S], as ``dual_attention_pallas`` draws them from a
    generator seeded ``seed`` on the card."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    m1 = torch.rand((n, s, s), generator=g, device="cuda") < 0.9
    m2 = torch.rand((n, s, s), generator=g, device="cuda") < 0.9
    return m1, m2


def check_k3(b: int, h: int, d: int, dtype, keep_masks: bool, s: int = 6) -> dict:
    """K3 through the public op ``dual_attention_pallas`` (dropout 0.1 from
    a seeded generator when ``keep_masks``) against the plain batch-major
    forward on the same masks; returns errors and times."""
    import torch

    from pmgt_tpu_torch.ops.dual_attention import (
        dual_attention_bm_forward,
        dual_attention_bm_reference,
        dual_attention_pallas,
    )

    seed = b * 31 + h * 7 + d
    q, k, v, c, _, mask4, _ = _bm_inputs(b, h, s, d, dtype, seed)
    n = b * h
    if keep_masks:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        out = dual_attention_pallas(q, k, v, c, mask4, 0.5, 0.1, False, gen)
        m1, m2 = _draw_bm_masks(n, s, seed)
    else:
        out = dual_attention_pallas(q, k, v, c, mask4, 0.5, 0.1, True, None)
        m1 = m2 = None
    torch.cuda.synchronize()
    fold = lambda x: x.reshape(n, s, d)  # noqa: E731
    mask_bs = mask4.expand(b, h, 1, s).reshape(n, s)
    args = (fold(q), fold(k), fold(v), fold(c), mask_bs, m1, m2, 0.5, 0.9, keep_masks)
    ref = dual_attention_bm_reference(*(x.float() for x in args[:4]), *args[4:])
    out = fold(out)
    if out.shape != ref.shape or not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"K3 output malformed at B·h={n} h={h} d={d} {dtype}")
    err = (out.float() - ref).abs().max().item()
    scale = ref.abs().max().item()
    if dtype == torch.float32:
        limit, tol = 1e-5 * max(1.0, scale), "max abs err <= 1e-5 * max(1, max|ref|)"
    else:
        limit, tol = 2e-2 * scale, "max abs err <= 2e-2 * max|out|"
    row = {
        "phase": "k3_check", "S": s, "B*h": n, "h": h, "d": d,
        "dtype": str(dtype).replace("torch.", ""), "keep_masks": keep_masks,
        "max_abs_err": err, "max_abs_out": scale, "limit": limit,
        "tolerance": tol, "ok": err <= limit,
        "ms": graph_ms(lambda: dual_attention_bm_forward(*args)),
        "cold_ms": cold_ms(lambda: dual_attention_bm_forward(*args)),
        "plain_ms": graph_ms(lambda: dual_attention_bm_reference(*args)),
    }
    row.update(k1_bound_ms(s, n, d, q.element_size(), 1 if keep_masks else 0))
    emit(row)
    if not row["ok"]:
        raise RuntimeError(f"K3 disagrees with its plain version: {row}")
    return row


def check_k4(b: int, h: int, d: int, keep_masks: bool, s: int = 6) -> dict:
    """K4 as the backward of ``DualAttentionBm`` (autograd) against the
    plain batch-major backward, f32, masked keys in every sequence and one
    zero context row; returns errors and times."""
    import torch

    from pmgt_tpu_torch.ops.dual_attention import (
        DualAttentionBm,
        dual_attention_bm_backward,
        dual_attention_bm_backward_reference,
    )

    seed = b * 13 + h * 5 + d
    q, k, v, c, go, mask4, zero_seq = _bm_inputs(b, h, s, d, torch.float32, seed)
    n = b * h
    fold = lambda x: x.reshape(n, s, d)  # noqa: E731
    q, k, v, c, go = map(fold, (q, k, v, c, go))
    mask_bs = mask4.expand(b, h, 1, s).reshape(n, s)
    m1, m2 = _draw_bm_masks(n, s, seed) if keep_masks else (None, None)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v, c)]
    out = DualAttentionBm.apply(*leaves, mask_bs, m1, m2, 0.5, 0.9, keep_masks)
    got = torch.autograd.grad(out, leaves, go)
    torch.cuda.synchronize()
    args = (q, k, v, c, mask_bs, m1, m2, go, 0.5, 0.9, keep_masks)
    want = dual_attention_bm_backward_reference(*args)
    errs, oks = {}, []
    for name, a, b_ in zip(("dq", "dk", "dv", "dc"), got, want):
        if a.shape != b_.shape or not bool(torch.isfinite(a).all()):
            raise RuntimeError(f"K4 {name} malformed at B·h={n} h={h} d={d}")
        err = (a - b_).abs().max().item()
        limit = 1e-5 * max(1.0, b_.abs().max().item())
        errs[name] = {"max_abs_err": err, "max_abs_ref": b_.abs().max().item(),
                      "limit": limit}
        oks.append(err <= limit)
    others = torch.ones(n, dtype=torch.bool, device="cuda")
    others[zero_seq] = False
    a, b_ = got[3][others], want[3][others]
    err = (a - b_).abs().max().item()
    limit = 1e-5 * max(1.0, b_.abs().max().item())
    errs["dc_without_zero_row"] = {"max_abs_err": err,
                                   "max_abs_ref": b_.abs().max().item(),
                                   "limit": limit}
    oks.append(err <= limit)
    row = {
        "phase": "k4_check", "S": s, "B*h": n, "h": h, "d": d, "dtype": "float32",
        "keep_masks": keep_masks, "errors": errs,
        "max_abs_err": max(errs[x]["max_abs_err"]
                           for x in ("dq", "dk", "dv", "dc_without_zero_row")),
        "tolerance": "each gradient max abs err <= 1e-5 * max(1, max|ref|)",
        "ok": all(oks),
        "ms": graph_ms(lambda: dual_attention_bm_backward(*args)),
        "cold_ms": cold_ms(lambda: dual_attention_bm_backward(*args)),
        "plain_ms": graph_ms(lambda: dual_attention_bm_backward_reference(*args)),
    }
    row.update(k2_bound_ms(s, n, d, 4, 1 if keep_masks else 0))
    emit(row)
    if not row["ok"]:
        raise RuntimeError(f"K4 disagrees with its plain version: {row}")
    return row


SWEEP_N = (1, 37, 3071)
SWEEP_S = (1, 2, 8, 9, 32)
SWEEP_D = (32, 96, 256)


def sweep_edges() -> dict:
    """Untimed: K1 (f32, bf16), K2, K3 (f32, bf16) and K4 against their
    plain versions at every (N, S, d) of SWEEP_N x SWEEP_S x SWEEP_D:
    ragged tiles, one-key rows, the 32-lane groups (S > 8), rows not a
    multiple of 128 features. In every input some sequences have every key
    masked but one; the keep masks cycle through none, bool and f32 (0/1
    floats) from one shape to the next. Tolerances as the timed checks:
    f32 1e-5 * max(1, max|ref|) per output, bf16 2e-2 * max|ref|. K3 and
    K4 run on the batch-major copies of the seq-major inputs."""
    import torch

    from pmgt_tpu_torch.ops import dual_attention as da

    worst, failures, count = {}, [], 0

    def hold(label, got, ref, bf16=False):
        nonlocal count
        count += 1
        scale = ref.abs().max().item()
        limit = 2e-2 * scale if bf16 else 1e-5 * max(1.0, scale)
        err = (got.float() - ref).abs().max().item()
        ok = err <= limit and bool(torch.isfinite(got).all())
        key = label.split("@")[0]
        if err / limit > worst.get(key, {"err_over_limit": -1.0})["err_over_limit"]:
            worst[key] = {"case": label, "max_abs_err": err, "limit": limit,
                          "err_over_limit": err / limit}
        if not ok:
            failures.append({"case": label, "max_abs_err": err, "limit": limit})

    bm = lambda x: None if x is None else x.transpose(0, 1).contiguous()  # noqa: E731
    with torch.no_grad():
        for idx, (n, s, d) in enumerate((n, s, d) for n in SWEEP_N
                                        for s in SWEEP_S for d in SWEEP_D):
            g = torch.Generator(device="cuda").manual_seed(1000 + idx)
            q, k, v, c, go = (torch.randn(s, n, d, generator=g, device="cuda")
                              for _ in range(5))
            mask = torch.zeros(n, s, device="cuda")
            n_ctx = torch.randint(0, s, (n,), generator=g, device="cuda")
            n_ctx[0] = 0  # every key masked but the first
            keys = torch.arange(s, device="cuda")
            mask[keys[None, :] > n_ctx[:, None]] = torch.finfo(torch.float32).min
            kind = ("none", "bool", "f32")[idx % 3]
            m1 = m2 = None
            if kind != "none":
                m1, m2 = (torch.rand(s, n, s, generator=g, device="cuda") < 0.9
                          for _ in range(2))
                if kind == "f32":
                    m1, m2 = m1.float(), m2.float()
            hyper = (0.5, 0.9, kind != "none")
            tag = f"@N={n},S={s},d={d},keep={kind}"
            ref = da.dual_attention_sm_reference(q, k, v, c, mask, m1, m2, *hyper)
            hold("k1_f32" + tag, da.dual_attention_sm_forward(
                q, k, v, c, mask, m1, m2, *hyper), ref)
            hold("k3_f32" + tag, da.dual_attention_bm_forward(
                *map(bm, (q, k, v, c)), mask, bm(m1), bm(m2), *hyper),
                bm(ref))
            h = [x.bfloat16() for x in (q, k, v, c)]
            ref16 = da.dual_attention_sm_reference(*(x.float() for x in h), mask,
                                                   m1, m2, *hyper)
            hold("k1_bf16" + tag, da.dual_attention_sm_forward(
                *h, mask, m1, m2, *hyper), ref16, bf16=True)
            hold("k3_bf16" + tag, da.dual_attention_bm_forward(
                *map(bm, h), mask, bm(m1), bm(m2), *hyper), bm(ref16), bf16=True)
            want = da.dual_attention_sm_backward_reference(
                q, k, v, c, mask, m1, m2, go, *hyper)
            got2 = da.dual_attention_sm_backward(q, k, v, c, mask, m1, m2, go, *hyper)
            got4 = da.dual_attention_bm_backward(
                *map(bm, (q, k, v, c)), mask, bm(m1), bm(m2), bm(go), *hyper)
            for name, a, a4, b in zip(("dq", "dk", "dv", "dc"), got2, got4, want):
                hold(f"k2_{name}" + tag, a, b)
                hold(f"k4_{name}" + tag, a4, bm(b))
            del q, k, v, c, go, ref, ref16, want, got2, got4, h
    torch.cuda.synchronize()
    row = {"phase": "edge_sweep", "N": SWEEP_N, "S": SWEEP_S, "d": SWEEP_D,
           "comparisons": count, "worst": worst, "failures": failures[:20],
           "ok": not failures}
    emit(row)
    if failures:
        raise RuntimeError(f"edge sweep: {len(failures)} comparisons failed: {failures[:5]}")
    return row


def ptxas_report() -> list:
    """Registers, stack and spills of every kernel instance, from the ptxas
    report (``-Xptxas -v``) that the build keeps beside each library."""
    import re

    from pmgt_tpu_torch.ops import build

    rows = []
    for name in build.KERNELS:
        with open(build.lib_path(name)[: -len(".so")] + ".log") as f:
            text = f.read()
        current = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                t = re.search(r"kernelI(f|13__nv_bfloat16)Li(\d+)E", m.group(1))
                current = {"kernel": name,
                           "dtype": {"f": "float32"}.get(t.group(1), "bfloat16") if t else "?",
                           "group_lanes": int(t.group(2)) if t else None}
                rows.append(current)
                continue
            if current is None:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m:
                current.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                current["registers"] = int(m.group(1))
    return rows


def capture_attention_inputs(task) -> dict:
    """q, k, v, c [S, N, d] and the additive mask [N, S] of the encoder's
    first layer on the first validation chunk (256 targets + 512 pair
    lanes = 768) of the task's data, from the task's current weights."""
    import torch

    from pmgt_tpu_torch.sampling.pairs import make_pretrain_batch_cached

    attn = task.model.bert.layers[0].self_attention
    captured = {}

    def keep_inputs(module, inputs, output):
        captured.setdefault("inp", inputs)  # returns None: output unchanged

    hook = attn.register_forward_hook(keep_inputs)
    try:
        ctx_ids, ctx_mask, pairs = task._get_ctx(("valid",))
        targets = torch.as_tensor(task.valid_nodes[: task.args.test_batch_size],
                                  device="cuda")
        batch = make_pretrain_batch_cached(ctx_ids, ctx_mask, targets, pairs)
        with torch.no_grad():
            task.model(task.feat_tables, batch, deterministic=True,
                       compute_nfr=False, proj_tables=task._proj_tables())
    finally:
        hook.remove()
    hidden_sm, additive_bs = captured["inp"][:2]
    s, n, hid = hidden_sm.shape
    d = task.config.head_dim
    flat = hidden_sm.reshape(s * n, hid)
    with torch.no_grad():
        q, k, v, c = (lin(flat).reshape(s, n, d) for lin in (
            attn.query, attn.key, attn.value, attn.ctx_attention))
    return {"q": q, "k": k, "v": v, "c": c, "mask": additive_bs, "beta": task.config.beta}


def check_cross_layout(inp: dict) -> dict:
    """K1 on the captured tensors seq-major against K3 on the same tensors
    permuted to [B, h, S, d] (h = 1); K2 against K4 likewise, with and
    without keep masks. Each output within 1e-6 * max(1, max|out|)."""
    import torch

    from pmgt_tpu_torch.ops.dual_attention import (
        dual_attention_bm_backward,
        dual_attention_bm_forward,
        dual_attention_pallas,
        dual_attention_sm_backward,
        dual_attention_sm_forward,
    )

    q, k, v, c, mask, beta = (inp[x] for x in ("q", "k", "v", "c", "mask", "beta"))
    s, n, d = q.shape
    bm = lambda x: x.permute(1, 0, 2).contiguous()  # noqa: E731  [S,N,·]→[N,S,·]
    g = torch.Generator(device="cuda").manual_seed(17)
    go = torch.randn(s, n, d, generator=g, device="cuda")
    m1 = torch.rand((s, n, s), generator=g, device="cuda") < 0.9
    m2 = torch.rand((s, n, s), generator=g, device="cuda") < 0.9
    errs, oks = {}, []

    def agree(name, a, b):
        err = (a - b).abs().max().item()
        limit = 1e-6 * max(1.0, b.abs().max().item())
        errs[name] = {"max_abs_err": err, "limit": limit}
        oks.append(err <= limit and bool(torch.isfinite(a).all()))

    with torch.no_grad():
        out_k1 = dual_attention_sm_forward(q, k, v, c, mask, beta=beta)
        out_k3 = dual_attention_pallas(*(bm(x)[:, None] for x in (q, k, v, c)),
                                       mask[:, None, None, :], beta, 0.1, True, None)
        agree("k3_vs_k1", out_k3[:, 0].permute(1, 0, 2), out_k1)
        out_k1m = dual_attention_sm_forward(q, k, v, c, mask, m1, m2, beta, 0.9, True)
        out_k3m = dual_attention_bm_forward(*map(bm, (q, k, v, c)), mask, bm(m1),
                                            bm(m2), beta, 0.9, True)
        agree("k3_vs_k1_keep_masks", out_k3m.permute(1, 0, 2), out_k1m)
        for label, keep_masks in (("", False), ("_keep_masks", True)):
            masks = (m1, m2) if keep_masks else (None, None)
            got_sm = dual_attention_sm_backward(q, k, v, c, mask, *masks, go, beta,
                                                0.9, keep_masks)
            got_bm = dual_attention_bm_backward(
                *map(bm, (q, k, v, c)), mask,
                *(bm(m) if keep_masks else None for m in (m1, m2)),
                bm(go), beta, 0.9, keep_masks)
            for name, a, b in zip(("dq", "dk", "dv", "dc"), got_bm, got_sm):
                agree(f"k4_vs_k2_{name}{label}", a.permute(1, 0, 2), b)
    torch.cuda.synchronize()
    row = {"phase": "cross_layout", "S": s, "N": n, "d": d,
           "source": "encoder layer 0 q/k/v/c on the first 768-lane validation chunk",
           "errors": errs, "tolerance": "max abs err <= 1e-6 * max(1, max|out|)",
           "ok": all(oks)}
    emit(row)
    if not row["ok"]:
        raise RuntimeError(f"the two layouts disagree: {row}")
    return row


def run_public_op(inp: dict, calls: int = 3) -> dict:
    """The batch-major path: ``dual_attention_pallas`` forward (dropout 0.1
    from a generator) and its autograd backward on the captured tensors as
    [B, 1, S, d] leaves, ``calls`` times. Counts zeroed just before, read
    just after: K3 == K4 == ``calls``, K1 == K2 == 0."""
    import torch

    from pmgt_tpu_torch.ops import dual_attention_pallas

    q, k, v, c, mask, beta = (inp[x] for x in ("q", "k", "v", "c", "mask", "beta"))
    s, n, d = q.shape
    to4 = lambda x: x.permute(1, 0, 2).reshape(n, 1, s, d).contiguous()  # noqa: E731
    gen = torch.Generator(device="cuda").manual_seed(23)
    go = torch.randn(n, 1, s, d, generator=gen, device="cuda")
    mask4 = mask[:, None, None, :]
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    finite = True
    for _ in range(calls):
        leaves = [to4(x).requires_grad_(True) for x in (q, k, v, c)]
        out = dual_attention_pallas(*leaves, mask4, beta, 0.1, False, gen)
        grads = torch.autograd.grad(out, leaves, go)
        finite = finite and all(bool(torch.isfinite(x).all()) for x in (out, *grads))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / calls
    launches = read_launches()
    ok = finite and launches == {"k1": 0, "k2": 0, "k3": calls, "k4": calls}
    row = {"phase": "public_op", "calls": calls, "shape": [n, 1, s, d],
           "host_ms_per_call": ms, "launches": launches, "finite": finite, "ok": ok}
    emit(row)
    if not ok:
        raise RuntimeError(f"the batch-major path did not run through K3/K4: {row}")
    return row


def run_cli(art, data_root: str, card: str) -> dict:
    """``train-pmgt`` through the port's ``main()`` at full width on the
    TG-shape data written with ``save_native``: 2 epochs, a resume to a
    third, ``--mode eval`` and ``--mode inference``. Counts zeroed just
    before and read just after each invocation; checkpoint saves timed in
    the run (synchronised host timers), resume and export times beside
    them."""
    import shutil

    import torch

    from pmgt_tpu_torch.cli.main import main as cli_main
    from pmgt_tpu_torch.core.config import TrainArgs
    from pmgt_tpu_torch.data.artifacts import save_native
    from pmgt_tpu_torch.tasks import pmgt_task
    from pmgt_tpu_torch.train import checkpoints, engine
    from pmgt_tpu_torch.train.registry import RunRegistry

    shutil.rmtree(data_root, ignore_errors=True)
    data_dir, log_dir = os.path.join(data_root, "data"), os.path.join(data_root, "logs")
    t0 = time.perf_counter()
    save_native(os.path.join(data_dir, "TG"), art)
    save_s = time.perf_counter() - t0

    saves = []
    real_save = engine.save_checkpoint

    def timed_save(path, payload):
        torch.cuda.synchronize()
        t = time.perf_counter()
        real_save(path, payload)
        paths = [path] if isinstance(path, str) else path
        saves.append({"checkpoint": "+".join(os.path.basename(p) for p in paths),
                      "ms": (time.perf_counter() - t) * 1e3})

    engine.save_checkpoint = timed_save
    base = ["--device", "cuda", "train-pmgt", "--model-name", "pmgt",
            "--dataset-name", "TG", "--data-dir", data_dir, "--log-dir", log_dir,
            "--early-criterion", "auc", "--seed", "0"]
    invocations = {}

    def invoke(label, *extra):
        torch.cuda.synchronize()
        zero_launches()
        t = time.perf_counter()
        out = cli_main([*base, *extra])
        torch.cuda.synchronize()
        invocations[label] = {"wall_s": time.perf_counter() - t,
                              "launches": read_launches()}
        return out

    try:
        test1 = invoke("train_2_epochs", "--num-epochs", "2")
        reg = RunRegistry(log_dir)
        (run,) = reg.list_runs()
        status1 = run.status
        rows1 = run.metrics()
        test2 = invoke("resume_to_3", "--num-epochs", "3", "--run-id", run.run_id)
        status2 = run.status
        test_eval = invoke("eval", "--mode", "eval", "--run-id", run.run_id)
        status3 = run.status
        emb_path = os.path.join(data_root, "emb.npy")
        invoke("inference", "--mode", "inference", "--run-id", run.run_id,
               "--inference-result-path", emb_path)
        status4 = run.status
    finally:
        engine.save_checkpoint = real_save
    rows = run.metrics()
    epochs = {}
    for m in rows:
        epochs.setdefault(m["epoch"], {})[m["name"]] = (m["value"], m["step"])
    best = checkpoints.read_best_info(run.ckpt_dir)

    # Restore `best` in this process and evaluate the validation split.
    args = TrainArgs(seed=0, run_id=run.run_id, data_dir=data_dir, log_dir=log_dir,
                     dataset_name="TG", model_name="pmgt", early_criterion="auc")
    ctx = {"device": "cuda"}
    pmgt_task.init_dataloader(args, ctx)
    pmgt_task.init_model(args, ctx)
    task = ctx["task"]
    best_path = reg.get_ckpt_path(run.run_id, load_best=True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    pmgt_task._restore_params_only(best_path, task)
    torch.cuda.synchronize()
    restore_best_ms = (time.perf_counter() - t) * 1e3
    best_auc = task.evaluate("valid")["val/auc"]

    # Resume cost: `last` from disk into the model and optimizer.
    last_path = os.path.join(run.ckpt_dir, "last")
    resume_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        task.load_state_dict(checkpoints.restore_checkpoint(last_path)["state"])
        torch.cuda.synchronize()
        resume_ms.append((time.perf_counter() - t) * 1e3)
    export_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        task.export_embeddings()
        torch.cuda.synchronize()
        export_ms.append((time.perf_counter() - t) * 1e3)
    emb = np.load(emb_path)

    steps = len(ctx["train_nodes"]) // 256
    chunks = math.ceil(len(ctx["valid_nodes"]) / 256)
    export_chunks = math.ceil(art.num_nodes / 256)
    layers = task.config.num_hidden_layers
    # K2: 5 per step; K1: as many plus 5 per evaluation chunk (each epoch's
    # validation and the closing test evaluation).
    want = {
        "train_2_epochs": {"k1": layers * (2 * steps + 3 * chunks), "k2": layers * 2 * steps},
        "resume_to_3": {"k1": layers * (steps + 2 * chunks), "k2": layers * steps},
        "eval": {"k1": layers * chunks, "k2": 0},
        "inference": {"k1": layers * export_chunks, "k2": 0},
    }
    launches_ok = all(
        invocations[k]["launches"] == {**w, "k3": 0, "k4": 0} for k, w in want.items()
    )
    auc_rows = [(e, v["val/auc"]) for e, v in sorted(epochs.items()) if "val/auc" in v]
    checks = {
        "finished_after_2_epochs": status1 == "FINISHED",
        "two_epoch_rows_with_val_auc": [e for e, _ in auc_rows[:2]] == [0, 1]
        and len([m for m in rows1 if m["name"] == "val/auc"]) == 2,
        "best_json": best is not None and best["monitor"] == "val/auc",
        "best_and_last": all(os.path.isdir(os.path.join(run.ckpt_dir, x))
                             for x in ("best", "last")),
        "resumed_one_epoch_to_step_99": [e for e, _ in auc_rows] == [0, 1, 2]
        and auc_rows[-1][1][1] == 3 * steps == 99 and status2 == "FINISHED",
        "eval_finite_and_status_untouched": all(np.isfinite(list(test_eval.values())))
        and status3 == status2,
        "inference_status_untouched": status4 == status2,
        "restored_best_reproduces_val_auc": abs(best_auc - best["value"]) <= 1e-6,
        "export": list(emb.shape) == [art.num_nodes, 128] and emb.dtype == np.float32
        and bool(np.isfinite(emb).all()),
        "launches": launches_ok,
    }
    row = {
        "phase": "cli",
        "card": card,
        "run_id": run.run_id,
        "dataset_write_s": save_s,
        "invocations": invocations,
        "expected_launches": want,
        "epoch_time_s": {e: v["epoch_time"][0] for e, v in epochs.items()
                         if "epoch_time" in v},
        "val_auc": {e: v[0] for e, v in auc_rows},
        "best": best,
        "restored_best_val_auc": best_auc,
        "test_after_train": test1,
        "test_after_resume": test2,
        "test_eval_mode": test_eval,
        "statuses": [status1, status2, status3, status4],
        "checkpoint_saves": saves,
        "checkpoint_bytes": os.path.getsize(os.path.join(last_path, checkpoints.CKPT_FILE)),
        "restore_best_params_ms": restore_best_ms,
        "resume_ms": resume_ms,
        "export_ms": export_ms,
        "export_shape": list(emb.shape),
        "checks": checks,
        "ok": all(checks.values()),
    }
    emit(row)
    if not row["ok"]:
        raise RuntimeError(f"train-pmgt end to end failed: {checks}")
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

    zero_launches()
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

    zero_launches()
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
        zero_launches()
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
          "seconds": time.perf_counter() - t0, "ptxas": ptxas_report()})

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
    k2_checks = [check_k2(6, n, 128, km) for n in (3072, 768, 256, 37)
                 for km in (False, True)]
    results["k2_checks"] = k2_checks

    # ---- 5b. untimed sweep of all four kernels over edge shapes ---------
    results["edge_sweep"] = sweep_edges()

    # ---- 8. K3 and K4, the batch-major kernels, against their plain versions
    k3_checks = [
        check_k3(n, 1, 128, dt, km)
        for n in (3072, 768)
        for dt in (torch.float32, torch.bfloat16)
        for km in (False, True)
    ]
    k3_checks += [check_k3(b, h, d, torch.float32, km)
                  for b, h, d in ((37, 1, 128), (384, 2, 64)) for km in (False, True)]
    k4_checks = [check_k4(b, h, d, km)
                 for b, h, d in ((3072, 1, 128), (768, 1, 128), (37, 1, 128), (384, 2, 64))
                 for km in (False, True)]
    results.update(k3_checks=k3_checks, k4_checks=k4_checks)

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

    # ---- 9. the two layouts on real tensors, and the batch-major path ----
    attn_inputs = capture_attention_inputs(task)
    cross = check_cross_layout(attn_inputs)
    public = run_public_op(attn_inputs)

    # ---- 10. train-pmgt end to end through the CLI ----------------------
    cli = run_cli(art, os.path.join(HERE, "outputs", "chip_smoke_cli"), smi)

    # ---- summary ---------------------------------------------------------
    # Each kernel at its main path's shape (K1/K2 the training lanes, K3/K4
    # the public op at 3,072 lanes) with keep masks (dropout on); launches
    # over every counted run, by path.
    def pick(rows, n):
        return next(r for r in rows if r.get("N", r.get("B*h")) == n and r["keep_masks"]
                    and r["dtype"] == "float32" and r.get("h", 1) == 1)

    cli_launches = {k: sum(v["launches"][k] for v in cli["invocations"].values())
                    for k in ("k1", "k2")}
    kernels = []
    for name, source, replaces, row, rows, launches in (
        ("dual_attention_fwd_sm", K1_SOURCE, K1_REPLACES, pick(checks, 3072),
         [r for r in checks if r["dtype"] == "float32"],
         {"serving": n_launches, "training": train["k1_launches"],
          "train_pmgt_cli": cli_launches["k1"]}),
        ("dual_attention_bwd_sm", K2_SOURCE, K2_REPLACES, pick(k2_checks, 3072), k2_checks,
         {"serving": kern["row"]["k2_launches"], "training": train["k2_launches"],
          "train_pmgt_cli": cli_launches["k2"]}),
        ("dual_attention_fwd_bm", K1_SOURCE, K3_REPLACES, pick(k3_checks, 3072),
         [r for r in k3_checks if r["dtype"] == "float32"],
         {"public_op": public["launches"]["k3"]}),
        ("dual_attention_bwd_bm", K2_SOURCE, K4_REPLACES, pick(k4_checks, 3072), k4_checks,
         {"public_op": public["launches"]["k4"]}),
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
            "cold_ms": row["cold_ms"],
            "bound_share": row["bound_ms"] / row["cold_ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,  # no single PyTorch call computes it
        })
    if any(k["launches"] == 0 for k in kernels):
        raise RuntimeError(f"a kernel was not launched on its path: {kernels}")
    results.update(kernels=kernels, slice_kernel=kern["row"],
                   slice_plain=ref["row"], train=train, train_routes=routes,
                   cross_layout=cross, public_op=public, cli=cli)
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
