"""Smoke test of the PyTorch/CUDA port on one GPU: builds the kernels,
holds each against its plain PyTorch version, drives the serving path and
the training path, and checks what comes out.

    python3 chip_smoke.py                 # one card
    python3 chip_smoke.py --scale         # one card: the scale smoke at 100k
                                          # and 1M nodes, 2.5M nodes bf16/int8
    python3 chip_smoke.py --multi-card [pmgt] [studies] [scale]
                                          # phase 21's PMGT jobs, the
                                          # hp-tuning command at 2 and 4 NCCL
                                          # ranks, a card each, and 2.5M nodes
                                          # sharded over 4 (all when none named)
    python3 chip_smoke.py --quality VG|TG [seed ...]
                                          # one card: validate_pipeline at the
                                          # published shape, 8 + 12 epochs,
                                          # downstream seeds 0 1 2 (or those
                                          # named) on one export, held against
                                          # QUALITY_<S>.json
    python3 chip_smoke.py --quality TG pmgt_ncf [seed ...]
                                          # the same with PMGT_NCF as the one
                                          # family, against
                                          # QUALITY_TG_PMGT_NCF.json
    python3 chip_smoke.py --quality int8  # int8 against bf16 tables, 8 epochs
    python3 chip_smoke.py --evidence dcn|dcn-frozen|neumf-pre|hpo-mlp|hpo-pmgt
                                          # one card: an evidence tool at its
                                          # published protocol, held against
                                          # the JAX record (``EVIDENCE``)
    python3 chip_smoke.py --bisect dcn-frozen|neumf-pre SEED
    python3 chip_smoke.py --bisect dcn-frozen-seeds [seed ...]
                                          # where a record missed a bound:
                                          # the spread it does not see
    python3 chip_smoke.py --bisect dcn-frozen-bf16 [seed ...]
                                          # the frozen DCN real arm with
                                          # every matmul at the TPU's
                                          # DEFAULT precision (bf16
                                          # operands, f32 sums), as the JAX
                                          # record was taken

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

10b. ``train-pmgt`` with scripts/run_pmgt.sh's arguments (hidden 32, 3
    layers, β 1.0, batch 32, test batch 64, lr 1e-4, decay 1e-2, max-norm
    5.0, ``--mp-enabled``, the kernel route) on phase 10's data: 1 epoch
    and ``--mode inference``, exact K1/K2 counts, the resident feature
    tables bf16 (half the f32 bytes). The same checkpoint exported on the
    plain route (bf16): max |diff| <= 5e-2·max|export| and mean <=
    1e-2·mean|export|; the same epoch on the plain route in bf16 (val
    AUC within 1e-2) and under the f32 policy (the gap
    printed); epoch, evaluate and export times.
11. K1 at the downstream lanes, f32 without keep masks (checked with
    phase 2): N=4,000 (a PMGT_NCF evaluation chunk: 4 users × 1,000
    candidates) and N=65,536 (the largest call of the serving item stage:
    64 users × 1,024 items); K2
    at N=256 (a PMGT_NCF training step) is among phase 5's shapes. The
    published configurations' bf16 operands are checked with phases 2 and
    5: K1 at d=32, N=384 (PMGT's training lanes: 32 targets + 320 pairs +
    32 masked) with and without keep masks and at d=128, N=4,000 and
    65,536; K2 at d=32, N=384 and d=128, N=128 (PMGT_NCF's training step).
    bf16 limits: K1 2e-2·max|out|, K2 2e-2·max(1, max|ref|) per gradient
    (both sides round the same f32 values to bf16); times and bounds at
    2-byte operands.
12. NCF NeuMF-end at the default width (factor 32, 3 layers: the MLP item
    table is 128 wide) on the whole TG-shape data (134,697 users), its MLP
    item table the port's own PMGT export from phase 10: 1 epoch,
    validation n20/r20, test, and the top 100 of every user served. Served
    ids are items or -1 (only on -inf slots), and no training positive is
    served.
13. PMGT_NCF NeuMF-end (the default PMGT encoder inside NCF) on the
    TG-shape graph and feature tables with the interactions of the first
    1,024 users only: 1 epoch (every step's loss finite; the mean BCE over
    all of the epoch's examples, dropout off, lower after the epoch than
    before), evaluate, serve
    the top 100 of every user; K1 == K2 == 5 a training step, K1 == 5 an
    evaluation chunk and a call of the serving item stage (once a batch of
    64 users over the whole catalogue, in calls of at most 64 × 1,024
    items), counts zeroed just before and read just after each. The same evaluation and serving on the plain
    attention route from the same weights and contexts: n20 and r20
    equal, loss within 1e-5, served scores within 1e-5 and every id the
    two routes serve differently a near-tie (the plain route's id scores,
    on the kernel route, within 1e-5 of the kernel route's at that slot).
    3 training steps on each route: step-1 gradients within 1e-4·max|g|
    (+1e-8), losses within 1e-4 relative.
14. DCN (factor 16, so its 128-wide item table takes the PMGT export) on
    the same cut: 1 epoch, validation and test AUC finite.
15. ``train-ncf`` (NeuMF-end with the PMGT export) and ``train-pmgt-ncf``
    through the port's CLI on the cut written with ``save_native``: 1 epoch
    each, then ``--mode eval`` and ``--mode inference``; every run
    FINISHED, eval reproducing the training run's test metrics within
    1e-6, exact K1/K2 counts for PMGT_NCF and none for NCF. Then
    ``train-ncf`` and ``train-dcn`` with the flags of scripts/run_ncf.sh and
    scripts/run_dcn.sh (``--mp-enabled`` among them, which changes nothing
    there), 1 epoch each, no kernel launched.
15b. ``train-pmgt-ncf`` with scripts/run_pmgt_ncf.sh's arguments (hidden
    128, 5 layers, factor 64, 2 layers, batch 128, test batch 256,
    ``--mp-enabled``) on the cut: 1 epoch with its test and a full serving
    sweep, exact K1/K2 counts, served ids items or -1 and no training
    positive served; the same checkpoint evaluated and served on the
    plain route in bf16: n10/r10/n20/r20 within 2e-2, each user's served
    score list within 5e-2·max(1, max|score|).
16. ``train-pmgt`` at the default width, one epoch of 4 steps
    (``--valid-size 0.9``), with ``--no-ctx-cache``,
    ``--gradient-checkpointing`` (K1 = 2·L, K2 = L a step),
    ``--position-embedding-type relative_key`` (K1 = K2 = 0: relative
    layers take the plain attention, as in JAX), ``--feat-tables-dtype
    int8`` and ``--profile-dir`` (a trace file written); step-1 gradients
    with and without checkpointing (f32) within 1e-6·max|g| + 1e-10.
16b. Six ``train_model`` calls in a fresh process (its first six
    profiler sessions), each with a ``profile_dir`` of its own, one step at
    hidden 32: every trace holds device kernel events and no call raised
    (``--profile-dir`` raises when a session records no device event).

17. ``preprocess`` through ``main()`` on a seeded review dump in the
    Amazon layout (``write_review_dump``: 12,000 items, 150,000 reviewers,
    940,000 reviews before 2015-01-01 and 60,000 after): node, edge, user
    and pair counts and each stage's host time; the native pair counter
    against scipy's sparse product (identical edges) and the native alias
    builder against the Python loop (bit-equal tables), each timed, on the
    run's own inputs; ``load_artifacts`` reading the result back; a second
    run with seeded ``_feats.npz`` files and ``--extract-features`` fills
    exactly those rows. At least 10,000 nodes; no kernel launched.
18. ``hp-tuning --train-name pmgt`` with config/hpo/hpo_pmgt_params.yaml and
    a copy of config/hpo/train_pmgt_params.json (``data_dir``,
    ``dataset_name`` and ``log_dir`` changed; one short epoch: valid 0.9,
    test batch 1,024) on phase 17's data: 2 trials, then the same study
    resumed to 3 (exactly one more). Per trial, counted by the port's
    trial records (read just before and just after each trial): its
    params, epoch time and objective; FINISHED; the objective equal to
    its logged ``val/auc`` within 1e-6; K2 = L a step and K1 = L a step +
    L an evaluation chunk; ``torch.cuda.memory_allocated()`` after
    ``gc.collect()`` back within 16 MB of its value before the first
    trial.
19. ``hp-tuning --train-name ncf --enable-trial-pruning`` with
    config/hpo/hpo_ncf_neumf_pmgt_params.yaml (NeuMF-PMGT, ``prune: true``
    arms), its batch pinned to 256 and its
    ``node_feat*_{32,64,128}dim.npy`` statics rewritten to
    ``train-pmgt --mode inference`` exports of phase 17's data at hidden
    32, 64 and 128 (each trained one short epoch first): 2 COMPLETE trials,
    every trial that drew a prune arm PRUNED and no other, ``should_prune``
    asked once an epoch and never True (the built-in study), each COMPLETE
    objective equal to its logged ``val/n20``.
20. The feature extractors (``data/feature_extraction.py``) on the card
    at Inception-v4's and BERT-base's output widths with seeded stand-in
    models (the card machine has no timm, transformers or PIL): 300 items
    of 1–3 3×299×299 arrays through ``extract_visual_features`` (a
    1,536-wide CNN with timm's surface, a numpy transform) and 1–3 reviews
    through ``extract_textual_features`` (a 768-wide encoder with a
    stand-in tokenizer, ``max_length`` 128). Each row equals a CPU
    recomputation with the same models within 1e-4; the rows written with
    ``save_feats_npz`` are consumed by ``preprocess --extract-features``
    on a seeded dump over the same items; times per 1,000 images and per
    1,000 reviews.
21. Data parallelism (run last). One NCCL rank on the card,
    this process joined through the multi-host trio's path
    (``initialize_distributed``):
    full-width ``train-pmgt`` with ``--shard-feat-tables
    --shard-graph-tables`` (one epoch, evaluate, export), then one epoch
    of ``run_training`` with the trio (engine, run registry,
    checkpoints), so every collective of the port runs on NCCL. Two gloo
    ranks sharing the card (NCCL refuses two ranks on one card), spawned
    by the port's launcher (``core/mesh.launch``): the default model on
    phase 10's data, 1,536 of the step's 3,072 lanes a rank, with
    replicated tables and with both shard flags, each against a 1-rank
    run of the same configuration (this process without a group; the
    NCCL rank for the sharded one): step losses within rtol 2e-4,
    parameters after the epoch within rtol 5e-4 + atol 1e-5 and bit-equal
    across the ranks, val AUC within 2e-4, export within
    1e-4·max|export|. In the same ranks NCF, DCN and PMGT_NCF (both shard
    flags) on phase 15's 1,024-user cut, one epoch each against 1 rank:
    losses within rtol 2e-4, n20 and r20 equal, the served top 100 equal
    outside near-ties (1e-4·max(1, max|score|)). Each line: backend,
    ranks, card, each rank's K1/K2 counts (zeroed just before and read
    just after), the step's time and its all-reduce and row-gather times
    (CUDA events). Then, in the same two gloo ranks,
    hp-tuning studies through ``hpo.run_study`` (the function the
    command's own launch runs in each rank; rank 0 owns the study and
    broadcasts each trial), on phase 17's data: PMGT with the published
    space drawing at full width (hidden 128, 3–5 layers, bf16, batch 32;
    one short epoch: valid 0.9, evaluation chunks of 1,024), 2 trials,
    then resumed to 3; NeuMF-PMGT with phase 19's space and
    ``--enable-trial-pruning``, 1 COMPLETE trial. Per trial,
    counted inside each rank: FINISHED once, the objective equal to its
    logged validation metric and to a 1-rank evaluation of the trial's
    best checkpoint in this process (PMGT AUC within 1e-5; NCF n20 and r20
    equal), a 1-rank re-run of its training within 2e-3 (the ranks train
    like one only to rounding, see ``check_study``), K1/K2 per
    rank as predicted (PMGT: L a step, K1 also L an evaluation chunk;
    NCF: none), ``should_prune`` asked once an epoch on both ranks
    exactly when pruning is on, and the card's allocated bytes after
    ``gc.collect()`` within 16 MB of that rank's level before the
    studies. ``--multi-card`` runs the ``hp-tuning`` command itself (its
    parser and launch) with the PMGT study at 2 and 4 NCCL ranks, a card
    each, on its TG-shape data, with the same checks. In the two gloo
    ranks the PMGT task's refresh budget with ``PMGT_TORCH_HBM_BYTES`` 0 on
    rank 0 (the floor, 8,192) and the card's memory on rank 1 (65,536):
    both ranks report the agreed 8,192.
22. Production scale (run before 21): ``tools/scale_smoke``'s
    configuration at 100,000 nodes (synthetic TG layout, average degree
    16, feature widths 1536/768; the default width under the bf16 policy,
    batch 512, ``gather_rows``): one refresh (two chunks of 65,536), one
    epoch (195 steps), valid AUC and export, K1 = 5·(steps + evaluation
    chunks + export chunks) and K2 = 5·steps exactly, the loss falling;
    one chunk's measured transient (``torch.cuda.max_memory_allocated``)
    within 25% of ``refresh_transient_bytes`` at 8,192, 16,384 and 65,536
    nodes; ``PMGT_TORCH_HBM_BYTES`` set so that the budget gives 16,384
    (seven chunks): the refresh's peak within the budget, and the chunked
    table's context distribution (context size and direct neighbours a
    node) within TV 0.05 of the unforced one's. Then step-1 gradients of
    the kernel route within 1e-4·max|g| of the plain route, under the f32
    policy. ``--scale`` runs the scale smoke at 100,000 and 1,000,000 nodes
    (a warm-up and 3 measured epochs each) and 2,500,000 nodes with bf16
    and int8 tables (one refresh and 3 steps), with memory, refresh, step
    and rate; ``--multi-card scale`` the 2,500,000 nodes row-sharded over 4
    NCCL ranks against one card: each rank's tables the total over 4 up to
    the block's padding, one chunk on every rank, losses within rtol 2e-4.
23. End-to-end quality (run before 21): ``tools/validate_pipeline`` at
    the VG shape (7,252 nodes, 27,988 users, 98,278 interactions, signal
    0.6) with 1 PMGT epoch (the default model, bf16 policy, batch 256,
    test batch 512) and 1 epoch of NeuMF-end with and without the export,
    GMF, MLP, NeuMF-pre and DCN with and without it: every metric finite,
    AUC/N@k/R@k in [0, 1] and losses at least 0; K2 = 5 a PMGT step and K1
    = 5 a step, an evaluation chunk and an export chunk, exactly (the
    downstream families launch no kernel); the export [7,252, 128] and
    finite. Then ``tools/reproduce_published --fixture`` on
    tests/fixtures/ref_mini: every stage ``ok``. ``--quality`` writes the
    full records (``outputs/QUALITY_TORCH_*.json``).
24. The evidence tools (run before 21), all five at once: ``tools/
    dcn_sensitivity`` on phase 23's VG export (1 seed, 1 epoch) without
    and with ``--freeze``, ``tools/neumf_pre_bisect`` at its small default
    size (2 epochs, ladder 1e-3, 1e-4:2), and ``tools/hpo_tg_study`` and
    ``tools/hpo_pmgt_study`` with one trial of one epoch and one
    ``hp-tuning`` round on a 2,000-node TG-layout dataset. Every report
    has the JAX tool's keys with finite numbers; the frozen ``zero`` arm's
    AUC is exactly 0.5; each restored best checkpoint equals its trial's
    logged results within 1e-5; K1/K2 of every PMGT process (pre-training
    and export at d = 32, 64, 128; each trial at its d and β; the
    restore) exactly as the code predicts. ``--evidence`` writes the full
    records (``outputs/DCN_SENSITIVITY_TORCH_*.json``,
    ``QUALITY_TORCH_NEUMF_PRE_BISECT_TG.json``, ``HPO_TORCH_TG_*.json``).
K1 and K2 are also checked (phases 2 and 5) at the quality tools' PMGT
shapes, bf16 at d = 128: K1 at N = 3,072, 1,536 and 512 with and without
keep masks, K2 at N = 3,072 with keep masks. And at the PMGT search space's
shapes: bf16, S = 6, N = 384, keep masks, at d = 64 and at d = 32 with β =
0, 0.25 and 1; at β = 0 K2's dc must be exactly 0 on both sides.

After the serving and training runs, one pass under ``torch.profiler``
(one evaluate and one export; one training step) gives the device's busy
time (summed kernel time) against the host wall time, and K1's and K2's
parts of it; phase 7 profiles a step of each route in one session, and
one last session profiles a training step, an evaluation and one serving
user batch of NCF and of PMGT_NCF, and a training step of the published
bf16 PMGT, its evaluation, and a training step and a serving user batch of
the published bf16 PMGT_NCF (five sessions in all; phase 16's
``--profile-dir`` opens a sixth after them, read only for its file). The
command time is printed before the ``kernels`` line.

Float32 matmuls run in full f32 (TF32 off) on both paths. Detailed
results also go to ``outputs/chip_smoke.json``. The last line of
standard output is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

T_START = time.perf_counter()
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


def zero_launches() -> None:
    """Zero the program's counters, the four kernels' launches among them."""
    from pmgt_tpu_torch.core import tracing

    tracing.reset_counters()


def read_launches() -> dict:
    """The four kernels' launches since the last ``zero_launches()``."""
    from pmgt_tpu_torch.ops.dual_attention import launch_counts

    return launch_counts()


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def clock(after: str) -> None:
    """The script's elapsed seconds after a phase."""
    emit({"phase": "clock", "after": after, "s": time.perf_counter() - T_START})


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


def check_k1(s: int, n: int, d: int, dtype, keep_masks: bool, beta: float = 0.5) -> dict:
    """K1 against its plain version on one input, the cosine branch
    weighted ``beta``; returns errors, times."""
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
    args = (q, k, v, c, mask, m1, m2, beta, 0.9, keep_masks)

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
        limit, tol = 1e-5, "max abs err <= 1e-5"
    else:
        limit, tol = 2e-2 * scale, "max abs err <= 2e-2 * max|out|"
    ok = err <= limit
    row = {
        "phase": "k1_check", "S": s, "N": n, "d": d, "beta": beta,
        "dtype": str(dtype).replace("torch.", ""), "keep_masks": keep_masks,
        "max_abs_err": err, "max_abs_out": scale, "limit": limit, "tolerance": tol, "ok": ok,
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


def check_k2(s: int, n: int, d: int, keep_masks: bool, dtype=None, beta: float = 0.5) -> dict:
    """K2 against its plain version on one input (masked keys in every
    sequence, one zero context row) in ``dtype`` (f32 by default; the plain
    version computes in f32 and rounds as the kernel does), the cosine
    branch weighted ``beta``; at β = 0 dc must be exactly 0 on both sides.
    Returns errors and times."""
    import torch

    from pmgt_tpu_torch.ops.dual_attention import (
        dual_attention_sm_backward,
        dual_attention_sm_backward_reference,
    )

    dtype = torch.float32 if dtype is None else dtype
    g = torch.Generator(device="cuda").manual_seed(s * 7_919 + n)
    q, k, v, c, go = (torch.randn(s, n, d, generator=g, device="cuda")
                      for _ in range(5))
    zero_seq = n // 2
    c[s - 1, zero_seq] = 0.0  # a zero context row
    q, k, v, c, go = (x.to(dtype) for x in (q, k, v, c, go))
    mask = torch.zeros(n, s, device="cuda")
    n_ctx = torch.randint(0, s, (n,), generator=g, device="cuda")
    keys = torch.arange(s, device="cuda")
    mask[keys[None, :] > n_ctx[:, None]] = torch.finfo(torch.float32).min
    m1 = m2 = None
    if keep_masks:
        m1 = torch.rand(s, n, s, generator=g, device="cuda") < 0.9
        m2 = torch.rand(s, n, s, generator=g, device="cuda") < 0.9
    args = (q, k, v, c, mask, m1, m2, go, beta, 0.9, keep_masks)

    got = dual_attention_sm_backward(*args)
    torch.cuda.synchronize()
    want = dual_attention_sm_backward_reference(*args)
    # f32: 1e-5 of the gradient's scale; bf16: both sides round f32 values
    # to bf16, so a pair may differ by one bf16 step (2^-8 of the value)
    rel = 1e-5 if dtype == torch.float32 else 2e-2
    errs, oks = {}, []
    for name, a, b in zip(("dq", "dk", "dv", "dc"), got, want):
        if a.shape != b.shape or a.dtype != dtype or not bool(torch.isfinite(a).all()):
            raise RuntimeError(f"K2 {name} malformed at S={s} N={n} d={d} {dtype}")
        a, b = a.float(), b.float()
        err = (a - b).abs().max().item()
        tol = rel * max(1.0, b.abs().max().item())
        errs[name] = {"max_abs_err": err, "max_abs_ref": b.abs().max().item(),
                      "limit": tol}
        oks.append(err <= tol)
    others = torch.ones(n, dtype=torch.bool, device="cuda")
    others[zero_seq] = False
    a, b = got[3][:, others].float(), want[3][:, others].float()
    err = (a - b).abs().max().item()
    tol = rel * max(1.0, b.abs().max().item())
    errs["dc_without_zero_row"] = {"max_abs_err": err,
                                   "max_abs_ref": b.abs().max().item(),
                                   "limit": tol}
    oks.append(err <= tol)
    if beta == 0.0:  # no cosine branch: no gradient into c, and no NaN
        errs["dc_exactly_zero"] = bool((got[3] == 0).all() and (want[3] == 0).all())
        oks.append(errs["dc_exactly_zero"])
    row = {
        "phase": "k2_check", "S": s, "N": n, "d": d, "beta": beta,
        "dtype": str(dtype).replace("torch.", ""),
        "keep_masks": keep_masks, "errors": errs,
        # the largest error among the gradients without the zero row's dc
        "max_abs_err": max(errs[x]["max_abs_err"]
                           for x in ("dq", "dk", "dv", "dc_without_zero_row")),
        "limit": min(errs[x]["limit"] for x in ("dq", "dk", "dv", "dc_without_zero_row")),
        "tolerance": f"each gradient max abs err <= {rel:g} * max(1, max|ref|)",
        "ok": all(oks),
        "ms": graph_ms(lambda: dual_attention_sm_backward(*args)),
        "cold_ms": cold_ms(lambda: dual_attention_sm_backward(*args)),
        "plain_ms": graph_ms(lambda: dual_attention_sm_backward_reference(*args)),
    }
    row.update(k2_bound_ms(s, n, d, q.element_size(), 1 if keep_masks else 0))
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
    launches, k2_launches = read_launches()["k1"], read_launches()["k2"]

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
    k1, k2 = read_launches()["k1"], read_launches()["k2"]

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


def compare_training_routes(make_task, phase: str = "train_route_check") -> dict:
    """Three steps on the kernel route and on the plain route from the same
    weights, training draw and per-step generators. Step-1 gradients within
    1e-4 * max|g| + 1e-8 per parameter (the floor is for the key biases,
    whose gradient is zero up to rounding: a softmax ignores a constant
    added to every key's score), losses within 1e-4 relative; the plain
    route launches no kernel. A fourth step of each route runs under the
    profiler (not counted)."""
    import torch

    kern, plain = make_task("pallas"), make_task("xla")
    plain.model.load_state_dict(kern.model.state_dict())
    kern.on_epoch_start(0)
    plain._train_ctx, plain._train_ctx_tag = kern._train_ctx, kern._train_ctx_tag
    launches, losses, grads, fourth = {}, {}, {}, {}
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
        launches[name] = (read_launches()["k1"], read_launches()["k2"])
        fourth[name] = (task, batches[3])
    # one profiler session for both routes' fourth step
    busy = profile_phases(tuple(
        (name, lambda t=t, b=b: (t.train_step(b), torch.cuda.synchronize()))
        for name, (t, b) in fourth.items()))
    busy = {name: {"train_step": busy[name]} if busy else {} for name in fourth}
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
        "phase": phase,
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


# ---- the downstream recommenders -------------------------------------------

PMGT_NCF_USERS = 1024  # interactions of the first 1,024 users (PMGT_NCF, DCN, CLI)


def cut_users(art, n_users: int):
    """The artifacts with only the interactions of users [0, n_users) (the
    graph and feature tables whole)."""
    from pmgt_tpu_torch.data.artifacts import DatasetArtifacts

    def keep(p):
        return p[p[:, 0] < n_users]

    return DatasetArtifacts(
        graph=art.graph, feat_init_embs=art.feat_init_embs,
        train_pairs=keep(art.train_pairs), test_pairs=keep(art.test_pairs),
        num_users=n_users, num_items=art.num_items,
        item_classes=art.item_classes, node_classes=art.node_classes)


def downstream_task(module: str, art, model_name: str, **extra):
    """A downstream task of ``pmgt_tpu_torch.tasks.<module>`` on the card
    through the workload contract's ``init_dataloader`` / ``init_model``,
    seed 0, 1 epoch, the commands' defaults for everything not in
    ``extra``."""
    import importlib

    from pmgt_tpu_torch.core.config import TrainArgs

    trainer = importlib.import_module(f"pmgt_tpu_torch.tasks.{module}")
    crit = "auc" if module == "dcn_task" else "n20"
    args = TrainArgs(seed=0, model_name=model_name, num_epochs=1, early_criterion=crit,
                     extra=dict(extra))
    ctx = {"artifacts": art, "device": "cuda"}
    trainer.check_args(args)
    trainer.init_dataloader(args, ctx)
    trainer.init_model(args, ctx)
    return ctx["task"]


def task_of(module: str, args, art):
    """The task of ``pmgt_tpu_torch.tasks.<module>`` for ``args`` (as a
    command resolves them) on ``art``, on the card."""
    import importlib

    trainer = importlib.import_module(f"pmgt_tpu_torch.tasks.{module}")
    ctx = {"artifacts": art, "device": "cuda"}
    trainer.check_args(args)
    trainer.init_dataloader(args, ctx)
    trainer.init_model(args, ctx)
    return ctx["task"]


def timed(fn):
    """(fn(), ms) with the card synchronised before the stop."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def serve_encoder_calls(num_users: int, num_items: int, user_batch: int = 64,
                        item_chunk: int = 1024, k: int = 100) -> int:
    """The encoder calls of PMGT_NCF's ``export_topk(k, user_batch,
    item_chunk)``: each batch of users (the last padded to a whole one)
    runs the scorer's item stage once over the catalogue, in calls of at
    most batch × chunk items."""
    batch = min(user_batch, num_users)
    chunk = min(max(item_chunk, min(k, num_items)), num_items)
    return math.ceil(num_users / batch) * math.ceil(num_items / (batch * chunk))


def serve_checks(task, out: dict) -> dict:
    """Every served id is an item or -1 (only on a -inf slot), and no
    training positive is served."""
    data = task.train_data
    ids, scores = out["item_ids"], out["scores"]
    in_range = bool(((ids >= 0) & (ids < data.num_items) | (ids == -1)).all())
    minus_one_on_inf = bool(((ids == -1) == np.isneginf(scores)).all())
    pairs = data.pairs.astype(np.int64)
    train_keys = pairs[:, 0] * data.num_items + pairs[:, 1]
    served = out["user_ids"].astype(np.int64)[:, None] * data.num_items + ids
    leaked = int(np.isin(served[ids >= 0], train_keys).sum())
    return {"ids_in_range_or_minus_one": in_range, "minus_one_only_on_minus_inf": minus_one_on_inf,
            "training_positives_served": leaked,
            "ok": in_range and minus_one_on_inf and leaked == 0}


def epoch_losses(losses: np.ndarray) -> dict:
    """The epoch's step count, whether every loss is finite, and the means
    of its first and last thirds."""
    third = max(len(losses) // 3, 1)
    return {"steps": len(losses), "finite": len(losses) > 0 and bool(np.isfinite(losses).all()),
            "loss_first_third": float(losses[:third].mean()),
            "loss_last_third": float(losses[-third:].mean())}


def pmgt_ncf_train_set_loss(task, epoch: int) -> float:
    """Mean BCE of PMGT_NCF over all of the epoch's training examples on
    the epoch's contexts, dropout off: the same examples before and after
    the epoch, so the difference is what the steps learned (a step's loss
    on its own batch moves by more than one epoch of learning)."""
    import torch

    from pmgt_tpu_torch.models.pmgt import bce_with_logits

    task.on_epoch_start(epoch)
    users, items, labels = task._epoch_arrays
    total = 0.0
    with torch.no_grad():
        for s in range(0, len(users), 4096):
            u, i, lab = users[s:s + 4096], items[s:s + 4096], labels[s:s + 4096]
            seqs, mask = task._sequences(i, task._train_ctx)
            logits = task.model(task.feat_tables, u, seqs, mask, item=i, deterministic=True)
            total += bce_with_logits(logits, lab).sum().item()
    return total / len(users)


def run_ncf(art, emb_path: str) -> dict:
    """NCF NeuMF-end at the default width (factor 32, 3 layers: the MLP
    item table is 128 wide) on the whole TG-shape data, its MLP item table
    the port's own PMGT export: 1 epoch, validation n20/r20, test, and the
    top 100 of every user served. Returns the row and the closures of its
    profiled pass."""
    import torch

    from pmgt_tpu_torch.data.artifacts import load_node_init_emb

    task, build_ms = timed(lambda: downstream_task(
        "ncf_task", art, "NeuMF-end", item_init_emb_path=emb_path))
    emb = load_node_init_emb(art.item_classes, art.node_classes, np.load(emb_path))
    injected = bool(np.array_equal(task.model.embed_item_MLP.weight.detach().cpu().numpy(), emb))
    _, draw_ms = timed(lambda: task.on_epoch_start(0))
    losses, epoch_ms = timed(lambda: task.train_epoch(0))
    losses = losses.cpu().numpy()
    val, first_eval_ms = timed(lambda: task.evaluate("valid"))  # draws the candidates
    val2, eval_ms = timed(lambda: task.evaluate("valid"))
    test, first_test_ms = timed(lambda: task.evaluate("test"))
    out, serve_ms = timed(lambda: task.export_topk(k=100))
    served = serve_checks(task, out)
    loss_row = epoch_losses(losses)
    metrics_ok = bool(np.isfinite([*val.values(), *test.values()]).all())
    row = {
        "phase": "ncf", "data": "TG-shape, all 134,697 users", "model": "NeuMF-end",
        "factor_num": 32, "num_layers": 3,
        "item_table": list(task.model.embed_item_MLP.weight.shape),
        "train_pairs": len(task.train_data.pairs), "valid_users": len(task.valid_data.unique_users),
        "test_users": len(task.test_data.unique_users),
        "pmgt_export_injected": injected, "build_ms": build_ms, "epoch_draw_ms": draw_ms,
        "epoch_ms": epoch_ms, "mean_step_ms": epoch_ms / max(len(losses), 1), **loss_row,
        "valid": val, "valid_repeat_max_diff": max(abs(val[k] - val2[k]) for k in val),
        "evaluate_first_ms": first_eval_ms, "evaluate_ms": eval_ms,
        "test": test, "test_first_ms": first_test_ms,
        "serve_users": len(out["user_ids"]), "serve_ms": serve_ms, "served": served,
        "ok": injected and loss_row["finite"] and metrics_ok and served["ok"]
        and max(abs(val[k] - val2[k]) for k in val) <= 1e-6,
    }
    emit(row)
    if not row["ok"]:
        raise RuntimeError(f"NCF failed: {row}")
    batch = next(task.train_batches(1))
    score = task.scorer()
    users = torch.arange(256, device="cuda")
    pos = torch.as_tensor(task.positives()[:256], dtype=torch.int64, device="cuda")
    profiled = (
        ("ncf_train_step", lambda: (task.train_step(batch), torch.cuda.synchronize())),
        ("ncf_evaluate", lambda: task.evaluate("valid")),
        ("ncf_serving_user_batch", lambda: (task.serve_users(score, users, pos, 100, 8192),
                                            torch.cuda.synchronize())),
    )
    return {"row": row, "profiled": profiled}


def rescore(task, users: np.ndarray, items: np.ndarray) -> np.ndarray:
    """Deterministic scores of (user, item) pairs on ``task``'s route."""
    import torch

    with torch.no_grad():
        score = task.scorer()
        return score(torch.as_tensor(users, dtype=torch.int64, device="cuda"),
                     torch.as_tensor(items, dtype=torch.int64, device="cuda")).cpu().numpy()


def run_pmgt_ncf(art_cut) -> dict:
    """PMGT_NCF (NeuMF-end, the default PMGT encoder: hidden 128, 5 layers,
    1 head, β 0.5, hops 16/8/4, dropout 0.1; factor 32, 3 layers) on the
    TG-shape graph and feature tables with the first 1,024 users'
    interactions: 1 epoch (K1 == K2 == 5 a step), evaluate (K1 == 5 a
    chunk of 4 users × 1,000 candidates) and serve the top 100 of every
    user (K1 == 5 a call of the item stage: ``serve_encoder_calls``); then
    the same
    evaluation and serving on the plain attention route from the same
    weights and contexts, and 3 training steps on each route."""
    import torch

    from pmgt_tpu_torch.tasks.pmgt_ncf_task import PMGTNCFTask

    task, build_ms = timed(lambda: downstream_task("pmgt_ncf_task", art_cut, "NeuMF-end"))
    layers = task.config.num_hidden_layers
    _, draw_ms = timed(lambda: task.on_epoch_start(0))
    before = pmgt_ncf_train_set_loss(task, 0)
    zero_launches()
    losses, epoch_ms = timed(lambda: task.train_epoch(0))
    train_launches = read_launches()
    losses = losses.cpu().numpy()
    after = pmgt_ncf_train_set_loss(task, 0)
    loss_row = {**epoch_losses(losses), "train_set_loss_before": before,
                "train_set_loss_after": after}
    loss_row["ok"] = loss_row["finite"] and after < before
    steps = len(losses)

    _, eval_draw_ms = timed(task.eval_ctx)
    task.evaluate("valid")  # draws the candidates; not counted
    zero_launches()
    val, eval_ms = timed(lambda: task.evaluate("valid"))
    eval_launches = read_launches()
    n_valid = len(task.valid_data.unique_users)
    chunks = math.ceil(n_valid / task.eval_chunk_users)
    lanes = task.eval_chunk_users * task._eval_cache["valid"][1][1].shape[2]
    zero_launches()
    out, serve_ms = timed(lambda: task.export_topk(k=100, user_batch=64, item_chunk=1024))
    serve_launches = read_launches()
    tiles = math.ceil(art_cut.num_users / 64) * math.ceil(art_cut.num_items / 1024)
    encoder_calls = serve_encoder_calls(art_cut.num_users, art_cut.num_items)
    served = serve_checks(task, out)

    # the plain route on the same weights, contexts and candidates
    def on_route(impl):
        args = dataclasses.replace(task.args, extra={**task.args.extra, "attention_impl": impl})
        return PMGTNCFTask(args, art_cut, task.train_data, task.valid_data, task.test_data,
                           device="cuda")

    plain = on_route("xla")
    plain.model.load_state_dict(task.model.state_dict())
    plain._eval_ctx = task._eval_ctx
    plain._eval_cache = task._eval_cache
    zero_launches()
    val_p, eval_plain_ms = timed(lambda: plain.evaluate("valid"))
    out_p, serve_plain_ms = timed(lambda: plain.export_topk(k=100, user_batch=64, item_chunk=1024))
    plain_launches = read_launches()
    ids, ids_p = out["item_ids"], out_p["item_ids"]
    diff = ids != ids_p
    users_d, slots_d = np.nonzero(diff)
    # a plain-route id at a slot where the kernel route served another must
    # score, on the kernel route, within 1e-5 of the kernel route's score
    # there: the two routes swapped near-equal items only
    tie_gap = 0.0
    if len(users_d):
        alt = rescore(task, users_d, ids_p[users_d, slots_d])
        tie_gap = float(np.abs(alt - out["scores"][users_d, slots_d]).max())
    score_diff = float(np.abs(out["scores"] - out_p["scores"]).max())
    route = {
        "n20_equal": val["val/n20"] == val_p["val/n20"],
        "r20_equal": val["val/r20"] == val_p["val/r20"],
        "loss_diff": abs(val["val/loss"] - val_p["val/loss"]),
        "served_score_max_abs_diff": score_diff,
        "served_slots_differing": int(diff.sum()),
        "served_swaps_max_score_gap": tie_gap,
        "plain_launches": plain_launches,
    }
    route["ok"] = (route["n20_equal"] and route["r20_equal"] and route["loss_diff"] <= 1e-5
                   and score_diff <= 1e-5 and tie_gap <= 1e-5
                   and plain_launches == {"k1": 0, "k2": 0, "k3": 0, "k4": 0})

    # 3 training steps on each route from the same weights and draws
    fresh = {impl: on_route(impl) for impl in ("pallas", "xla")}
    fresh["xla"].model.load_state_dict(fresh["pallas"].model.state_dict())
    grads, step_losses, step_launches = {}, {}, {}
    for impl, t in fresh.items():
        zero_launches()
        ls = []
        for i, batch in zip(range(3), t.train_batches(0)):
            ls.append(t.accumulate_gradients(batch))
            if i == 0:
                grads[impl] = {n: p.grad.detach().clone() for n, p in t.model.named_parameters()
                               if p.grad is not None}
            t.optimizer.step()
        step_losses[impl] = torch.stack(ls).cpu().numpy()
        step_launches[impl] = read_launches()
    worst = 0.0
    for n, gk in grads["pallas"].items():
        gp = grads["xla"][n]
        worst = max(worst, (gk - gp).abs().max().item() / (1e-4 * gp.abs().max().item() + 1e-8))
    loss_rel = float(np.max(np.abs(step_losses["pallas"] - step_losses["xla"])
                            / np.abs(step_losses["xla"])))
    train_route = {"losses_kernel": step_losses["pallas"].tolist(),
                   "losses_plain": step_losses["xla"].tolist(), "loss_max_rel_diff": loss_rel,
                   "step1_grad_err_over_limit": worst, "launches": step_launches,
                   "ok": worst <= 1.0 and loss_rel <= 1e-4
                   and step_launches["pallas"]["k1"] == step_launches["pallas"]["k2"] == 3 * layers
                   and step_launches["xla"] == {"k1": 0, "k2": 0, "k3": 0, "k4": 0}}

    want = {"train": {"k1": layers * steps, "k2": layers * steps, "k3": 0, "k4": 0},
            "evaluate": {"k1": layers * chunks, "k2": 0, "k3": 0, "k4": 0},
            "serve": {"k1": layers * encoder_calls, "k2": 0, "k3": 0, "k4": 0}}
    launches = {"train": train_launches, "evaluate": eval_launches, "serve": serve_launches}
    metrics_ok = bool(np.isfinite(list(val.values())).all())
    row = {
        "phase": "pmgt_ncf", "data": f"TG-shape graph and features, interactions of the first "
        f"{PMGT_NCF_USERS} users", "model": "NeuMF-end",
        "train_pairs": len(task.train_data.pairs), "valid_users": n_valid,
        "build_ms": build_ms, "epoch_draw_ms": draw_ms, "epoch_ms": epoch_ms,
        "mean_step_ms": epoch_ms / max(steps, 1), "lanes_per_step": task.args.train_batch_size,
        **loss_row, "losses": losses.tolist(),
        "eval_ctx_draw_ms": eval_draw_ms, "valid": val, "evaluate_ms": eval_ms,
        "eval_chunks": chunks, "eval_lanes_per_chunk": lanes,
        "evaluate_plain_ms": eval_plain_ms, "valid_plain": val_p,
        "serve_tiles": tiles, "serve_pairs_per_tile": 64 * 1024,
        "serve_encoder_calls": encoder_calls, "serve_ms": serve_ms,
        "serve_plain_ms": serve_plain_ms, "served": served,
        "launches": launches, "expected_launches": want,
        "route_check": route, "train_route_check": train_route,
        "ok": loss_row["ok"] and metrics_ok and served["ok"] and launches == want
        and route["ok"] and train_route["ok"],
    }
    emit(row)
    if not row["ok"]:
        raise RuntimeError(f"PMGT_NCF failed: {row}")
    batch = next(task.train_batches(1))
    score = task.scorer()
    users = torch.arange(64, device="cuda")
    pos = torch.as_tensor(task.positives()[:64], dtype=torch.int64, device="cuda")
    profiled = (
        ("pmgt_ncf_train_step", lambda: (task.train_step(batch), torch.cuda.synchronize())),
        ("pmgt_ncf_evaluate", lambda: task.evaluate("valid")),
        ("pmgt_ncf_serving_user_batch", lambda: (task.serve_users(score, users, pos, 100, 1024),
                                                 torch.cuda.synchronize())),
    )
    return {"row": row, "profiled": profiled}


def run_dcn(art_cut, emb_path: str) -> dict:
    """DCN (its defaults with factor 16, so the item table is 16·2³ = 128
    wide and takes the PMGT export) on the first 1,024 users'
    interactions: 1 epoch, validation and test AUC finite."""
    task, build_ms = timed(lambda: downstream_task(
        "dcn_task", art_cut, "DCN", factor_num=16, item_init_emb_path=emb_path))
    losses, epoch_ms = timed(lambda: task.train_epoch(0))
    losses = losses.cpu().numpy()
    val, eval_ms = timed(lambda: task.evaluate("valid"))
    test = task.evaluate("test")
    ok = bool(np.isfinite(losses).all() and np.isfinite(list(val.values())).all()
              and np.isfinite(list(test.values())).all()) and len(losses) > 0
    row = {"phase": "dcn", "data": f"interactions of the first {PMGT_NCF_USERS} users",
           "factor_num": 16, "item_table": list(task.model.item_embeddings.weight.shape),
           "build_ms": build_ms, "steps": len(losses), "epoch_ms": epoch_ms,
           "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
           "valid": val, "test": test, "evaluate_ms": eval_ms, "ok": ok}
    emit(row)
    if not ok:
        raise RuntimeError(f"DCN failed: {row}")
    return row


def run_downstream_cli(art_cut, data_root: str, emb_path: str, emb32_path: str) -> dict:
    """``train-ncf`` (NeuMF-end with the PMGT export) and ``train-pmgt-ncf``
    (NeuMF-end) through the port's ``main()`` on the first 1,024 users'
    interactions written with ``save_native``: 1 epoch each, then ``--mode
    eval`` and ``--mode inference``; then ``train-ncf`` and ``train-dcn``
    with the flags of scripts/run_ncf.sh and scripts/run_dcn.sh
    (``--mp-enabled`` included; the 128-wide export for NCF, the published
    PMGT's 32-wide one for DCN), 1 epoch each. Counts zeroed just before and
    read just after each invocation; PMGT_NCF's are exact, NCF and DCN
    launch none."""
    import shutil

    import torch

    from pmgt_tpu_torch.cli.main import main as cli_main
    from pmgt_tpu_torch.data.artifacts import save_native
    from pmgt_tpu_torch.tasks.interaction_base import split_interactions
    from pmgt_tpu_torch.core.config import TrainArgs
    from pmgt_tpu_torch.train.registry import RunRegistry

    shutil.rmtree(data_root, ignore_errors=True)
    data_dir = os.path.join(data_root, "data")
    save_native(os.path.join(data_dir, "TGcut"), art_cut)
    invocations, outs = {}, {}
    for cmd, model, extra in (
        ("train-ncf", "NeuMF-end", ["--item-init-emb-path", emb_path]),
        ("train-pmgt-ncf", "NeuMF-end", []),
    ):
        log_dir = os.path.join(data_root, f"logs_{cmd}")
        base = ["--device", "cuda", cmd, "--model-name", model, "--dataset-name", "TGcut",
                "--data-dir", data_dir, "--log-dir", log_dir, "--early-criterion", "n20",
                "--seed", "0", *extra]
        npz = os.path.join(data_root, f"{cmd}_top.npz")
        for mode, more in (("train", ["--num-epochs", "1"]), ("eval", ["--mode", "eval"]),
                           ("inference", ["--mode", "inference", "--inference-result-path", npz])):
            if mode != "train":
                (run,) = RunRegistry(log_dir).list_runs()
                more = [*more, "--run-id", run.run_id]
            torch.cuda.synchronize()
            zero_launches()
            t = time.perf_counter()
            outs[(cmd, mode)] = cli_main([*base, *more])
            torch.cuda.synchronize()
            (run,) = RunRegistry(log_dir).list_runs()
            invocations[f"{cmd} {mode}"] = {"wall_s": time.perf_counter() - t,
                                            "launches": read_launches(), "status": run.status}
    # NCF and DCN with their scripts' flags (--mp-enabled among them)
    for cmd, flags, emb in (("train-ncf", PUBLISHED_NCF, emb_path),
                            ("train-dcn", PUBLISHED_DCN, emb32_path)):
        log_dir = os.path.join(data_root, f"logs_{cmd}_published")
        label = f"{cmd} published"
        outs[(cmd, "published")] = cli_invoke(
            ["--device", "cuda", cmd, "--dataset-name", "TGcut", "--data-dir", data_dir,
             "--log-dir", log_dir, *flags, "--item-init-emb-path", emb, "--num-epochs", "1"],
            invocations, label)
        (run,) = RunRegistry(log_dir).list_runs()
        invocations[label]["status"] = run.status
    data = split_interactions(TrainArgs(seed=0), art_cut)
    steps = len(data["train_data"].pairs) * 2 // 256
    chunk = lambda d: math.ceil(len(d.unique_users) / 4)  # noqa: E731
    encoder_calls = serve_encoder_calls(art_cut.num_users, art_cut.num_items)
    want = {
        "train-pmgt-ncf train": {"k1": 5 * (steps + chunk(data["valid_data"])
                                           + chunk(data["test_data"])), "k2": 5 * steps},
        "train-pmgt-ncf eval": {"k1": 5 * chunk(data["test_data"]), "k2": 0},
        "train-pmgt-ncf inference": {"k1": 5 * encoder_calls, "k2": 0},
    }
    npz_ok = {}
    for cmd in ("train-ncf", "train-pmgt-ncf"):
        z = np.load(os.path.join(data_root, f"{cmd}_top.npz"))
        npz_ok[cmd] = (z["item_ids"].shape == (art_cut.num_users, 100)
                       and bool(np.isfinite(z["scores"][z["item_ids"] >= 0]).all()))
    checks = {
        "statuses_finished": all(v["status"] == "FINISHED" for v in invocations.values()),
        "metrics_finite": all(np.isfinite(list(outs[(c, m)].values())).all()
                              for c in ("train-ncf", "train-pmgt-ncf") for m in ("train", "eval")),
        "eval_reproduces_train_test": all(
            abs(outs[(c, "train")][k] - outs[(c, "eval")][k]) <= 1e-6
            for c in ("train-ncf", "train-pmgt-ncf") for k in outs[(c, "train")]),
        "npz": all(npz_ok.values()),
        "pmgt_ncf_launches": all(
            invocations[k]["launches"] == {**w, "k3": 0, "k4": 0} for k, w in want.items()),
        "ncf_launches_none": all(invocations[f"train-ncf {m}"]["launches"]
                                 == {"k1": 0, "k2": 0, "k3": 0, "k4": 0}
                                 for m in ("train", "eval", "inference")),
        "published_ncf_dcn_mp": all(
            np.isfinite(list(outs[(c, "published")].values())).all()
            and invocations[f"{c} published"]["launches"] == {"k1": 0, "k2": 0, "k3": 0, "k4": 0}
            for c in ("train-ncf", "train-dcn")),
    }
    row = {"phase": "downstream_cli", "invocations": invocations, "expected_launches": want,
           "test_metrics": {f"{c} {m}": outs[(c, m)] for c, m in outs
                            if m in ("train", "eval", "published")},
           "checks": checks, "ok": all(checks.values())}
    emit(row)
    if not row["ok"]:
        raise RuntimeError(f"downstream CLI failed: {checks}")
    return row


# ---- the published scripts' configurations (bf16 compute policy) -----------

# scripts/run_pmgt.sh's arguments (its 30 epochs cut to PUBLISHED_PMGT_EPOCHS:
# 1 since the hp-tuning phases joined, which keeps the script near 480 s)
PUBLISHED_PMGT_EPOCHS = 1
PUBLISHED_PMGT = ["--model-name", "PMGT", "--lr", "1e-4", "--decay", "1e-2",
                  "--train-batch-size", "32", "--test-batch-size", "64",
                  "--early-criterion", "auc", "--seed", "0", "--early", "5",
                  "--hidden-size", "32", "--num-hidden-layers", "3", "--beta", "1.0",
                  "--valid-size", "0.1", "--gradient-max-norm", "5.0", "--mp-enabled",
                  "--attention-impl", "pallas", "--experiment-name", "PMGT",
                  "--run-name", "PMGT"]
# scripts/run_pmgt_ncf.sh's arguments (its 30 epochs cut to 1)
PUBLISHED_PMGT_NCF = ["--model-name", "NeuMF-end", "--lr", "1e-4", "--factor-num", "64",
                      "--num-layers", "2", "--num-ng", "1", "--hidden-size", "128",
                      "--num-hidden-layers", "5", "--train-batch-size", "128",
                      "--test-batch-size", "256", "--early-criterion", "n20", "--seed", "0",
                      "--early", "5", "--mp-enabled", "--gradient-max-norm", "5.0",
                      "--experiment-name", "PMGT_NCF", "--run-name", "PMGT_NCF"]
# scripts/run_ncf.sh's and scripts/run_dcn.sh's (60 epochs cut to 1; each
# takes the item embeddings its script names: a 128-wide export for NCF,
# the published PMGT's 32-wide one for DCN)
PUBLISHED_NCF = ["--model-name", "NeuMF-end", "--lr", "1e-4", "--decay", "0",
                 "--emb-dropout", "0", "--dropout", "0", "--factor-num", "64",
                 "--num-layers", "2", "--num-ng", "1", "--train-batch-size", "128",
                 "--test-batch-size", "256", "--early-criterion", "n20", "--seed", "0",
                 "--early", "10", "--mp-enabled", "--gradient-max-norm", "5.0",
                 "--normalize-item-init-emb"]
PUBLISHED_DCN = ["--model-name", "DCN", "--lr", "1e-3", "--decay", "1e-3",
                 "--emb-dropout", "0.2", "--dropout", "0", "--factor-num", "16",
                 "--deep-net-num-layers", "1", "--cross-net-num-layers", "4", "--num-ng", "1",
                 "--train-batch-size", "128", "--test-batch-size", "256",
                 "--early-criterion", "auc", "--seed", "0", "--early", "10", "--mp-enabled",
                 "--gradient-max-norm", "5.0", "--use-layer-norm", "--normalize-item-init-emb"]


def cli_invoke(argv, invocations: dict, label: str):
    """``main(argv)`` with the counts zeroed just before and read just
    after; records the wall time and the launches under ``label``."""
    import torch

    from pmgt_tpu_torch.cli.main import main as cli_main

    torch.cuda.synchronize()
    zero_launches()
    t = time.perf_counter()
    out = cli_main(argv)
    torch.cuda.synchronize()
    invocations[label] = {"wall_s": time.perf_counter() - t, "launches": read_launches()}
    return out


def args_of(argv):
    """The ``TrainArgs`` a training command line resolves to (through
    ``--save-args``, as the command itself resolves them)."""
    import tempfile

    from pmgt_tpu_torch.cli.main import main as cli_main
    from pmgt_tpu_torch.core.config import TrainArgs

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "args.json")
        cli_main(["--save-args", path, *argv])
        return TrainArgs.load(path)


def auc_by_epoch(log_dir: str) -> dict:
    """{epoch: val/auc} and {epoch: epoch_time s} of the one run in
    ``log_dir``."""
    from pmgt_tpu_torch.train.registry import RunRegistry

    (run,) = RunRegistry(log_dir).list_runs()
    rows = run.metrics()
    return ({m["epoch"]: m["value"] for m in rows if m["name"] == "val/auc"},
            {m["epoch"]: m["value"] for m in rows if m["name"] == "epoch_time"}, run)


def run_published_pmgt(data_dir: str, root: str) -> dict:
    """``train-pmgt`` with scripts/run_pmgt.sh's arguments (hidden 32, 3
    layers, β 1.0, batch 32, ``--mp-enabled``, the kernel route) on the
    TG-shape data of the ``cli`` phase: ``PUBLISHED_PMGT_EPOCHS``, then ``--mode
    inference``; exact K1/K2 counts; the resident feature tables bf16. The
    same checkpoint exported on the plain route (bf16) within a bf16 limit;
    the same epochs on the plain route in bf16 (val AUC within 1e-2 at
    each epoch) and under the f32 policy (the gap printed). Evaluate and
    export times from the restored best checkpoint in this process."""
    import shutil

    import torch

    from pmgt_tpu_torch.core.quant import table_nbytes
    from pmgt_tpu_torch.tasks import pmgt_task

    shutil.rmtree(root, ignore_errors=True)
    epochs = PUBLISHED_PMGT_EPOCHS
    invocations, exports = {}, {}
    common = ["--dataset-name", "TG", "--data-dir", data_dir]

    def train(label, *extra):
        log_dir = os.path.join(root, f"logs_{label}")
        out = cli_invoke(["--device", "cuda", "train-pmgt", *common, "--log-dir", log_dir,
                          *PUBLISHED_PMGT, *extra, "--num-epochs", str(epochs)],
                         invocations, f"train_{label}")
        return out, log_dir

    def export(label, log_dir, run_id, *extra):
        path = os.path.join(root, f"emb_{label}.npy")
        cli_invoke(["--device", "cuda", "train-pmgt", *common, "--log-dir", log_dir,
                    *PUBLISHED_PMGT, *extra, "--mode", "inference", "--run-id", run_id,
                    "--inference-result-path", path], invocations, f"inference_{label}")
        exports[label] = np.load(path)
        return path

    test_k, log_k = train("kernel")
    auc_k, epoch_s, run = auc_by_epoch(log_k)
    emb_path = export("kernel", log_k, run.run_id)
    export("plain_same_params", log_k, run.run_id, "--attention-impl", "xla")
    test_p, log_p = train("plain", "--attention-impl", "xla")
    auc_p, _, _ = auc_by_epoch(log_p)
    argv_f32 = [x for x in PUBLISHED_PMGT if x != "--mp-enabled"]
    log_f = os.path.join(root, "logs_f32")
    cli_invoke(["--device", "cuda", "train-pmgt", *common, "--log-dir", log_f, *argv_f32,
                "--num-epochs", str(epochs)], invocations, "train_f32_policy")
    auc_f, epoch_s_f32, _ = auc_by_epoch(log_f)

    # the bf16 task in this process: resident tables, evaluate and export times
    args = args_of(["train-pmgt", *common, "--log-dir", log_k, *PUBLISHED_PMGT,
                    "--mode", "eval", "--run-id", run.run_id])
    ctx = {"device": "cuda"}
    pmgt_task.init_dataloader(args, ctx)
    pmgt_task.init_model(args, ctx)
    task = ctx["task"]
    pmgt_task._maybe_restore(args, task, load_best=True)
    tables = {"dtypes": [str(t.dtype).replace("torch.", "") for t in task.feat_tables],
              "bytes": sum(table_nbytes(t) for t in task.feat_tables),
              "f32_bytes": sum(4 * t.numel() for t in task.feat_tables)}
    task.evaluate("valid")
    _, evaluate_ms = timed(lambda: task.evaluate("valid"))
    task.export_embeddings()
    _, export_ms = timed(task.export_embeddings)

    layers = task.config.num_hidden_layers
    steps = len(ctx["train_nodes"]) // 32
    chunks = math.ceil(len(ctx["valid_nodes"]) / 64)
    export_chunks = math.ceil(task.artifacts.num_nodes / 64)
    none = {"k1": 0, "k2": 0, "k3": 0, "k4": 0}
    want = {"train_kernel": {**none, "k1": layers * (epochs * steps + (epochs + 1) * chunks),
                             "k2": layers * epochs * steps},
            "inference_kernel": {**none, "k1": layers * export_chunks},
            "inference_plain_same_params": none, "train_plain": none,
            "train_f32_policy": {**none,
                                 "k1": layers * (epochs * steps + (epochs + 1) * chunks),
                                 "k2": layers * epochs * steps}}
    emb_k, emb_p = exports["kernel"], exports["plain_same_params"]
    diff = np.abs(emb_k - emb_p)
    auc_gap = max(abs(auc_k[e] - auc_p[e]) for e in auc_k)
    checks = {
        "launches": all(invocations[k]["launches"] == w for k, w in want.items()),
        "tables_bf16": tables["dtypes"] == ["bfloat16", "bfloat16"]
        and 2 * tables["bytes"] == tables["f32_bytes"],
        "export": emb_k.shape == (task.artifacts.num_nodes, 32) and emb_k.dtype == np.float32
        and bool(np.isfinite(emb_k).all()),
        "val_auc_each_epoch": sorted(auc_k) == list(range(epochs)) == sorted(auc_p)
        == sorted(auc_f),
        "routes_val_auc_within_1e-2": auc_gap <= 1e-2,
        "routes_export_within_bf16_limit": float(diff.max()) <= 5e-2 * float(np.abs(emb_k).max())
        and float(diff.mean()) <= 1e-2 * float(np.abs(emb_k).mean()),
        "metrics_finite": bool(np.isfinite([*test_k.values(), *test_p.values()]).all()),
    }
    row = {
        "phase": "published_pmgt", "script": f"scripts/run_pmgt.sh ({epochs} of its 30 epochs)",
        "invocations": invocations, "expected_launches": want,
        "steps_per_epoch": steps, "eval_chunks": chunks,
        "feature_tables": tables, "val_auc_kernel": auc_k, "val_auc_plain": auc_p,
        "val_auc_f32_policy": auc_f, "routes_val_auc_max_gap": auc_gap,
        "bf16_vs_f32_policy_val_auc_gap": {e: auc_k[e] - auc_f[e] for e in auc_k},
        "routes_export_max_abs_diff": float(diff.max()),
        "routes_export_mean_abs_diff": float(diff.mean()),
        "export_max_abs": float(np.abs(emb_k).max()),
        "epoch_s": epoch_s, "epoch_s_f32_policy": epoch_s_f32,
        "evaluate_ms": evaluate_ms, "export_ms": export_ms,
        "test_kernel": test_k, "test_plain": test_p,
        "checks": checks, "ok": all(checks.values()),
    }
    emit(row)
    if not row["ok"]:
        raise RuntimeError(f"published PMGT failed: {checks}")
    batch = next(task.train_batches(5))
    task.on_epoch_start(5)
    profiled = (
        ("published_pmgt_train_step", lambda: (task.train_step(batch), torch.cuda.synchronize())),
        ("published_pmgt_evaluate", lambda: task.evaluate("valid")),
    )
    return {"row": row, "emb_path": emb_path, "profiled": profiled}


def served_rows_close(a: dict, b: dict) -> dict:
    """Two serving exports of the same users: each user's served score
    list (descending, as served) on one route against the other's, so a
    near-tie served in the other order does not count; and the share of
    slots whose ids differ."""
    sa, sb = a["scores"], b["scores"]
    fin = np.isfinite(sa) & np.isfinite(sb)
    diff = np.abs(np.subtract(sa, sb, where=fin, out=np.zeros_like(sa)))
    return {"score_max_abs_diff": float(diff.max()), "score_max_abs": float(np.abs(sa[fin]).max()),
            "slots_differing": int((a["item_ids"] != b["item_ids"]).sum()),
            "same_minus_inf": bool((np.isneginf(sa) == np.isneginf(sb)).all())}


def run_published_pmgt_ncf(art_cut, data_dir: str, root: str) -> dict:
    """``train-pmgt-ncf`` with scripts/run_pmgt_ncf.sh's arguments (hidden
    128, 5 layers, factor 64, 2 layers, batch 128, ``--mp-enabled``) on the
    1,024-user cut written by ``downstream_cli``: 1 epoch with its test,
    then a full serving sweep; exact K1/K2 counts; served ids items or -1
    and no training positive served. The same checkpoint evaluated and
    served on the plain route in bf16: n20/r20 within 2e-2 and the served
    score lists within 5e-2·max(1, max|score|)."""
    import shutil

    import torch

    from pmgt_tpu_torch.core.config import TrainArgs
    from pmgt_tpu_torch.tasks.interaction_base import split_interactions
    from pmgt_tpu_torch.train.registry import RunRegistry

    shutil.rmtree(root, ignore_errors=True)
    log_dir = os.path.join(root, "logs")
    base = ["--device", "cuda", "train-pmgt-ncf", "--dataset-name", "TGcut", "--data-dir",
            data_dir, "--log-dir", log_dir, *PUBLISHED_PMGT_NCF]
    invocations, served = {}, {}
    test_k = cli_invoke([*base, "--num-epochs", "1"], invocations, "train")
    (run,) = RunRegistry(log_dir).list_runs()
    rid = ["--run-id", run.run_id]
    for label, extra in (("kernel", []), ("plain", ["--attention-impl", "xla"])):
        npz = os.path.join(root, f"top_{label}.npz")
        cli_invoke([*base, *extra, "--mode", "inference", *rid, "--inference-result-path", npz],
                   invocations, f"inference_{label}")
        z = np.load(npz)
        served[label] = {k: z[k] for k in z.files}
    test_p = cli_invoke([*base, "--attention-impl", "xla", "--mode", "eval", *rid],
                        invocations, "eval_plain")

    data = split_interactions(TrainArgs(seed=0), art_cut)
    train_data = data["train_data"]
    steps = len(train_data.pairs) * 2 // 128
    chunk = lambda d: math.ceil(len(d.unique_users) / 4)  # noqa: E731
    tiles = math.ceil(art_cut.num_users / 64) * math.ceil(art_cut.num_items / 1024)
    encoder_calls = serve_encoder_calls(art_cut.num_users, art_cut.num_items)
    none = {"k1": 0, "k2": 0, "k3": 0, "k4": 0}
    want = {"train": {**none, "k1": 5 * (steps + chunk(data["valid_data"])
                                         + chunk(data["test_data"])), "k2": 5 * steps},
            "inference_kernel": {**none, "k1": 5 * encoder_calls},
            "inference_plain": none, "eval_plain": none}

    class _Task:  # what serve_checks reads
        pass

    holder = _Task()
    holder.train_data = train_data
    checks_k = serve_checks(holder, served["kernel"])
    close = served_rows_close(served["kernel"], served["plain"])
    n_gap = max(abs(test_k[k] - test_p[k]) for k in ("test/n20", "test/r20", "test/n10",
                                                       "test/r10"))
    checks = {
        "launches": all(invocations[k]["launches"] == w for k, w in want.items()),
        "served_ids": checks_k["ok"],
        "served_all_users": served["kernel"]["item_ids"].shape == (art_cut.num_users, 100),
        "routes_ranking_within_2e-2": n_gap <= 2e-2,
        "routes_scores_within_bf16_limit": close["same_minus_inf"]
        and close["score_max_abs_diff"] <= 5e-2 * max(1.0, close["score_max_abs"]),
        "metrics_finite": bool(np.isfinite([*test_k.values(), *test_p.values()]).all()),
    }
    row = {"phase": "published_pmgt_ncf", "script": "scripts/run_pmgt_ncf.sh (1 of its 30 "
           "epochs)", "data": f"interactions of the first {PMGT_NCF_USERS} users",
           "invocations": invocations, "expected_launches": want, "steps": steps,
           "serve_tiles": tiles, "serve_encoder_calls": encoder_calls, "test_kernel": test_k,
           "test_plain_same_params": test_p,
           "routes_ranking_max_gap": n_gap, "routes_served": close, "served": checks_k,
           "checks": checks, "ok": all(checks.values())}
    emit(row)
    if not row["ok"]:
        raise RuntimeError(f"published PMGT_NCF failed: {checks}")

    # the same configuration in this process, for one profiled pass
    args = args_of(["train-pmgt-ncf", "--dataset-name", "TGcut", "--data-dir", data_dir,
                    "--log-dir", log_dir, *PUBLISHED_PMGT_NCF])
    task = task_of("pmgt_ncf_task", args, art_cut)
    task.on_epoch_start(0)
    batch = next(task.train_batches(0))
    score = task.scorer()
    users = torch.arange(64, device="cuda")
    pos = torch.as_tensor(task.positives()[:64], dtype=torch.int64, device="cuda")
    profiled = (
        ("published_pmgt_ncf_train_step", lambda: (task.train_step(batch),
                                                   torch.cuda.synchronize())),
        ("published_pmgt_ncf_serving_user_batch", lambda: (
            task.serve_users(score, users, pos, 100, 1024), torch.cuda.synchronize())),
    )
    return {"row": row, "profiled": profiled}


# ----------------------------------------------------------------------
# 21. data parallelism: one NCCL rank, and two gloo ranks sharing the card
# ----------------------------------------------------------------------

MR_PMGT_JOBS = (("replicated", {}),
                ("sharded", {"shard_feat_tables": True, "shard_graph_tables": True}))
# The refresh budget of the gloo ranks: rank 0 budgets no memory (the
# chunk's floor, 8,192), rank 1 the card's; both must draw in 8,192.
MR_BUDGET_ENV = (0, None)
MR_DOWNSTREAM_JOBS = (("ncf", "ncf_task", "NeuMF-end", {}),
                      ("dcn", "dcn_task", "DCN", {}),
                      ("pmgt_ncf", "pmgt_ncf_task", "NeuMF-end",
                       {"shard_feat_tables": True, "shard_graph_tables": True}))


def _mr_timed(fn):
    """(fn(), ms, collective ms by kind, K1/K2 launches): the counts and
    the collectives' CUDA-event sums zeroed just before and read just
    after, the card synchronised before the stop."""
    import torch

    from pmgt_tpu_torch.core import mesh

    zero_launches()
    mesh.timing_ms()
    out, ms = timed(fn)
    launches = read_launches()
    return out, ms, mesh.timing_ms(), {"k1": launches["k1"], "k2": launches["k2"]}


_MR_ARTIFACTS = {}


def _mr_artifacts(data_dir: str, name: str):
    """The dataset ``name`` under ``data_dir``, loaded once a process."""
    from pmgt_tpu_torch.data.artifacts import load_artifacts

    if (data_dir, name) not in _MR_ARTIFACTS:
        _MR_ARTIFACTS[(data_dir, name)] = load_artifacts(data_dir, name)
    return _MR_ARTIFACTS[(data_dir, name)]


def _mr_pmgt(data_dir: str, extra: dict) -> dict:
    """One epoch of train-pmgt (default model, TG-shape data), then
    evaluate and export, through the workload contract."""
    from pmgt_tpu_torch.core.config import TrainArgs
    from pmgt_tpu_torch.tasks import pmgt_task

    args = TrainArgs(seed=0, test_batch_size=256, num_epochs=1, data_dir=data_dir,
                     dataset_name="TG", extra=dict(extra))
    ctx = {"device": "cuda", "artifacts": _mr_artifacts(data_dir, "TG")}
    pmgt_task.check_args(args)
    pmgt_task.init_dataloader(args, ctx)
    pmgt_task.init_model(args, ctx)
    task = ctx["task"]
    _, draw_ms, draw_coll, _ = _mr_timed(lambda: task.on_epoch_start(0))
    losses, epoch_ms, coll, train_l = _mr_timed(lambda: task.train_epoch(0).cpu().numpy())
    (metrics, emb), eval_ms, eval_coll, eval_l = _mr_timed(
        lambda: (task.evaluate("valid"), task.export_embeddings()))
    steps = len(losses)
    return {"losses": losses, "steps": steps, "draw_ms": draw_ms, "draw_collective_ms": draw_coll,
            "epoch_ms": epoch_ms, "step_ms": epoch_ms / steps,
            "all_reduce_ms_per_step": coll.get("all_reduce", 0.0) / steps,
            "row_gather_ms_per_step": coll.get("gather_rows", 0.0) / steps,
            "train_launches": train_l, "eval_export_ms": eval_ms,
            "eval_export_collective_ms": eval_coll, "eval_export_launches": eval_l,
            "metrics": metrics, "emb": emb, "fusion": task.config.fusion_strategy,
            "params": {k: v.detach().cpu() for k, v in task.model.state_dict().items()}}


def _mr_downstream(data_dir: str, module: str, model_name: str, extra: dict) -> dict:
    """One epoch of a downstream task on the 1,024-user cut, then its
    validation metrics and the top 100 of every user."""
    from pmgt_tpu_torch.core.config import TrainArgs

    crit = "auc" if module == "dcn_task" else "n20"
    args = TrainArgs(seed=0, model_name=model_name, num_epochs=1, early_criterion=crit,
                     data_dir=data_dir, dataset_name="TGcut", extra=dict(extra))
    task = task_of(module, args, _mr_artifacts(data_dir, "TGcut"))
    _, draw_ms, _, _ = _mr_timed(lambda: task.on_epoch_start(0))
    losses, epoch_ms, coll, train_l = _mr_timed(lambda: task.train_epoch(0).cpu().numpy())
    serve = {"user_batch": 64, "item_chunk": 1024} if module == "pmgt_ncf_task" else {}
    (metrics, top), eval_ms, _, eval_l = _mr_timed(
        lambda: (task.evaluate("valid"), task.export_topk(k=100, **serve)))
    steps = len(losses)
    return {"losses": losses, "steps": steps, "draw_ms": draw_ms, "epoch_ms": epoch_ms,
            "step_ms": epoch_ms / max(steps, 1),
            "all_reduce_ms_per_step": coll.get("all_reduce", 0.0) / max(steps, 1),
            "row_gather_ms_per_step": coll.get("gather_rows", 0.0) / max(steps, 1),
            "train_launches": train_l, "eval_serve_ms": eval_ms, "eval_serve_launches": eval_l,
            "metrics": metrics, "top": top}


def _mr_refresh_agreement(data_dir: str, hbm_bytes) -> dict:
    """The default PMGT task's refresh budget in this rank with
    ``PMGT_TORCH_HBM_BYTES`` = ``hbm_bytes`` (None: unset): the chunk this
    rank's budget gives and the chunk the ranks agreed on."""
    from pmgt_tpu_torch.core.config import TrainArgs
    from pmgt_tpu_torch.core.device import MEMORY_ENV
    from pmgt_tpu_torch.sampling.pairs import effective_refresh_chunk
    from pmgt_tpu_torch.tasks import pmgt_task

    saved = os.environ.pop(MEMORY_ENV, None)
    if hbm_bytes is not None:
        os.environ[MEMORY_ENV] = str(hbm_bytes)
    try:
        args = TrainArgs(seed=0, test_batch_size=256, num_epochs=1, data_dir=data_dir,
                         dataset_name="TG")
        ctx = {"device": "cuda", "artifacts": _mr_artifacts(data_dir, "TG")}
        pmgt_task.init_dataloader(args, ctx)
        pmgt_task.init_model(args, ctx)
    finally:
        os.environ.pop(MEMORY_ENV, None)
        if saved is not None:
            os.environ[MEMORY_ENV] = saved
    task = ctx["task"]
    return {"hbm_bytes": hbm_bytes, **task.refresh,
            "own_chunk": effective_refresh_chunk(task.graph, task.sampling,
                                                 task.refresh["free_bytes"])}


def multi_rank_work(pmgt_data: str, cut_data: str, jobs, downstream, studies=(),
                    budget_env=None) -> dict:
    """The multi_rank phase's work in one rank (or, without a group, in
    this process): the PMGT jobs, then the downstream jobs, then (with
    ``budget_env``, a ``PMGT_TORCH_HBM_BYTES`` value a rank) the PMGT
    task's refresh budget, then each hp-tuning study of ``studies``
    ((name, [``StudySpec``, ...]): the specs run one after the other, a
    resume after a first run) through ``hpo.run_study`` inside the group,
    with the card's allocated bytes before the first study and the launch
    counts zeroed just before and read just after the studies."""
    sys.path.insert(0, HERE)
    import gc

    import torch

    from pmgt_tpu_torch.cli import hpo
    from pmgt_tpu_torch.core import mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m = mesh.current_mesh("cuda")
    mesh.enable_timing()
    out = {"rank": m.rank, "ranks": m.size, "backend": m.backend,
           "card": f"cuda:{torch.cuda.current_device()} of {torch.cuda.device_count()}"}
    for name, extra in jobs:
        t = time.perf_counter()
        out[name] = _mr_pmgt(pmgt_data, extra)
        out[name]["job_s"] = time.perf_counter() - t
    for name, module, model_name, extra in downstream:
        t = time.perf_counter()
        out[name] = _mr_downstream(cut_data, module, model_name, extra)
        out[name]["job_s"] = time.perf_counter() - t
    mesh.enable_timing(False)
    if budget_env is not None:
        out["refresh_agreement"] = _mr_refresh_agreement(pmgt_data, budget_env[m.rank])
    if studies:
        gc.collect()
        torch.cuda.synchronize()
        out["memory_base"] = torch.cuda.memory_allocated()
        zero_launches()
        for name, specs in studies:
            t = time.perf_counter()
            out[name] = [hpo.run_study(spec) for spec in specs]
            out[f"{name}_s"] = time.perf_counter() - t
        out["study_launches"] = read_launches()
    return out


def _mr_close(ref: dict, got: dict) -> dict:
    """A rank's PMGT run against the 1-rank run: step losses (rtol 2e-4),
    parameters (rtol 5e-4, atol 1e-5), val AUC (2e-4), export (1e-4 of
    its largest magnitude)."""
    loss_rel = float(np.max(np.abs(got["losses"] - ref["losses"]) / np.abs(ref["losses"])))
    param_excess = max(
        float(((g - r).abs() - (5e-4 * r.abs() + 1e-5)).max())
        for r, g in ((ref["params"][k].double(), got["params"][k].double()) for k in ref["params"]))
    auc_diff = abs(got["metrics"]["val/auc"] - ref["metrics"]["val/auc"])
    emb_diff = float(np.abs(got["emb"] - ref["emb"]).max())
    emb_scale = float(np.abs(ref["emb"]).max())
    return {"loss_max_rel_diff": loss_rel, "param_bound_excess": param_excess,
            "auc_diff": auc_diff, "export_max_abs_diff": emb_diff, "export_max_abs": emb_scale,
            "ok": (len(got["losses"]) == len(ref["losses"]) and loss_rel <= 2e-4
                   and param_excess <= 0 and auc_diff <= 2e-4 and emb_diff <= 1e-4 * emb_scale)}


def _mr_served_close(ref: dict, got: dict) -> dict:
    """Served top-100 lists of one run against another's: ids equal except
    at near-ties (a slot whose id differs has, in the reference list, a
    neighbour within 1e-4·max(1, max|score|), or is the last slot with the
    two runs' scores there that close)."""
    sa, sb = ref["scores"], got["scores"]
    tol = 1e-4 * max(1.0, float(np.abs(sa[np.isfinite(sa)]).max()))
    fin = np.isfinite(sa) & np.isfinite(sb)
    gap = np.full(sa.shape, np.inf)
    with np.errstate(invalid="ignore"):
        step = np.abs(np.diff(sa, axis=1))
    step = np.where(np.isfinite(step), step, np.inf)
    gap[:, 1:] = np.minimum(gap[:, 1:], step)
    gap[:, :-1] = np.minimum(gap[:, :-1], step)
    last = np.where(fin[:, -1], np.abs(sa[:, -1] - np.where(fin[:, -1], sb[:, -1], 0)), np.inf)
    gap[:, -1] = np.minimum(gap[:, -1], last)
    differ = ref["item_ids"] != got["item_ids"]
    return {"slots_differing": int(differ.sum()), "differing_not_near_tie":
            int((differ & (gap > tol)).sum()), "near_tie_tol": tol,
            "same_minus_inf": bool((np.isneginf(sa) == np.isneginf(sb)).all())}


def run_multi_rank(pmgt_data: str, cut_data: str, log_root: str, studies=()) -> dict:
    """Phase 21: data parallelism. (a) One NCCL rank on the card, this
    process joined through the multi-host trio's path: the sharded PMGT
    job, then one epoch of ``run_training`` with the trio (every
    collective of the port, on NCCL). (b) Two gloo ranks sharing the card,
    spawned by the port's launcher (``core/mesh.launch``): full-width
    train-pmgt with replicated tables and with ``--shard-feat-tables
    --shard-graph-tables``; (c) in the same ranks NCF, DCN and PMGT_NCF
    (the shard flags for PMGT_NCF) on the 1,024-user cut. Each against a
    1-rank run of the same configuration: the replicated and downstream
    jobs in this process, the sharded job on the NCCL rank. (d) In the
    same gloo ranks, after the jobs, the hp-tuning ``studies`` ((name,
    [StudySpec, ...], the dataset's nodes)) through ``hpo.run_study``,
    each held by ``check_study`` against 1-rank re-runs in this
    process."""
    import shutil

    from pmgt_tpu_torch.cli.main import run_training
    from pmgt_tpu_torch.core import mesh
    from pmgt_tpu_torch.core.config import TrainArgs
    from pmgt_tpu_torch.train.registry import RunRegistry

    shutil.rmtree(log_root, ignore_errors=True)
    t0 = time.perf_counter()
    mesh.initialize_distributed(f"127.0.0.1:{mesh.free_port()}", 1, 0, device="cuda",
                                timeout_s=300)
    try:
        nccl = multi_rank_work(pmgt_data, cut_data, MR_PMGT_JOBS[1:], ())
    finally:
        mesh.stop()
    args = TrainArgs(seed=0, test_batch_size=256, num_epochs=1, data_dir=pmgt_data,
                     dataset_name="TG", log_dir=os.path.join(log_root, "nccl"),
                     extra=dict(MR_PMGT_JOBS[1][1]))
    mesh.enable_timing()
    result, ms, coll, launches = _mr_timed(lambda: run_training(
        "pmgt", args, "cuda", (f"127.0.0.1:{mesh.free_port()}", 1, 0)))
    mesh.enable_timing(False)
    nccl["engine"] = {"test": result, "ms": ms, "collective_ms": coll, "launches": launches}
    nccl_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gloo = mesh.launch(multi_rank_work, 2, (pmgt_data, cut_data, MR_PMGT_JOBS,
                                            MR_DOWNSTREAM_JOBS,
                                            [(name, specs) for name, specs, _ in studies],
                                            MR_BUDGET_ENV),
                       device="cuda", backend="gloo", timeout_s=400, run_timeout_s=700)
    gloo_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = multi_rank_work(pmgt_data, cut_data, MR_PMGT_JOBS[:1], MR_DOWNSTREAM_JOBS)
    ref_s = time.perf_counter() - t0
    refs = {"replicated": ref["replicated"], "sharded": nccl["sharded"]}

    def row(r: dict, name: str) -> dict:
        j = r[name]
        return {"backend": r["backend"], "rank": r["rank"], "ranks": r["ranks"],
                "card": r["card"], "job_s": j["job_s"], "draw_ms": j["draw_ms"],
                "eval_ms": j.get("eval_export_ms", j.get("eval_serve_ms")),
                "steps": j["steps"], "step_ms": j["step_ms"],
                "all_reduce_ms_per_step": j["all_reduce_ms_per_step"],
                "row_gather_ms_per_step": j["row_gather_ms_per_step"],
                "k1_k2_train": j["train_launches"],
                "k1_k2_eval": j.get("eval_export_launches", j.get("eval_serve_launches"))}

    lines = []
    ok = True
    for name, _ in MR_PMGT_JOBS:
        checks = [_mr_close(refs[name], g[name]) for g in gloo]
        equal = all(torch_equal(gloo[0][name]["params"], g[name]["params"]) for g in gloo[1:])
        launched = all(g[name]["train_launches"]["k1"] > 0 and g[name]["train_launches"]["k2"] > 0
                       for g in gloo)
        good = all(c["ok"] for c in checks) and equal and launched
        ok &= good
        lines.append({"phase": "multi_rank", "job": f"pmgt_{name}", "fusion": refs[name]["fusion"],
                      "ranks": [row(g, name) for g in gloo],
                      "reference": row(nccl if name == "sharded" else ref, name),
                      "checks": checks, "params_bit_equal_across_ranks": equal,
                      "val_auc": [g[name]["metrics"]["val/auc"] for g in gloo],
                      "ok": good})
    for name, *_ in MR_DOWNSTREAM_JOBS:
        r0 = ref[name]
        checks = []
        for g in gloo:
            j = g[name]
            rel = float(np.max(np.abs(j["losses"] - r0["losses"]) / np.abs(r0["losses"])))
            same = {k: j["metrics"][k] == r0["metrics"][k] for k in r0["metrics"]
                    if not k.endswith("loss")}
            served = _mr_served_close(r0["top"], j["top"])
            checks.append({"loss_max_rel_diff": rel, "metrics_equal": same, "served": served,
                           "ok": rel <= 2e-4 and all(same.values())
                           and served["differing_not_near_tie"] == 0
                           and served["same_minus_inf"]})
        good = all(c["ok"] for c in checks)
        if name == "pmgt_ncf":
            good &= all(g[name]["train_launches"]["k1"] > 0 and g[name]["train_launches"]["k2"] > 0
                        for g in gloo)
        ok &= good
        lines.append({"phase": "multi_rank", "job": name, "ranks": [row(g, name) for g in gloo],
                      "reference": row(ref, name), "checks": checks,
                      "metrics": [g[name]["metrics"] for g in gloo],
                      "reference_metrics": r0["metrics"], "ok": good})
    agreement = [g["refresh_agreement"] for g in gloo]
    agreed = ([a["own_chunk"] for a in agreement] == [8_192, 65_536]
              and [a["chunk"] for a in agreement] == [8_192, 8_192])
    ok &= agreed
    lines.append({"phase": "multi_rank", "job": "refresh_agreement", "backend": gloo[0]["backend"],
                  "ranks": [{k: a[k] for k in ("hbm_bytes", "free_bytes", "own_chunk", "chunk")}
                            for a in agreement], "ok": agreed})
    t0 = time.perf_counter()
    study_results = {}
    for name, specs, num_nodes in studies:
        res = check_study("multi_rank_study", name, specs[-1], [g[name] for g in gloo],
                          os.path.join(log_root, "rerun"), num_nodes,
                          [g["memory_base"] for g in gloo])
        study_results[name] = res
        ok &= res["ok"]
    study_check_s = time.perf_counter() - t0
    eng = nccl["engine"]
    (eng_run,) = RunRegistry(args.log_dir).list_runs()
    eng["run_status"] = eng_run.status
    eng_ok = (np.isfinite(list(eng["test"].values())).all() and eng_run.status == "FINISHED"
              and eng["launches"]["k1"] > 0 and eng["launches"]["k2"] > 0)
    ok &= bool(eng_ok)
    lines.append({"phase": "multi_rank", "job": "nccl_one_rank", "backend": nccl["backend"],
                  "ranks": nccl["ranks"], "card": nccl["card"],
                  "sharded": row(nccl, "sharded"), "engine": eng, "ok": bool(eng_ok)})
    for line in lines:
        emit(line)
    summary = {"phase": "multi_rank", "nccl_one_rank_s": nccl_s, "gloo_launch_s": gloo_s,
               "reference_s": ref_s, "study_reruns_s": study_check_s,
               "studies_s_per_rank": {name: [g[f"{name}_s"] for g in gloo]
                                      for name, _, _ in studies},
               "ok": bool(ok)}
    emit(summary)
    if not ok:
        raise RuntimeError("the multi-rank runs disagree with the 1-rank runs or launched no kernel")
    launches = {k: sum(g[j]["train_launches"][k] + g[j].get(
                    "eval_export_launches", g[j].get("eval_serve_launches"))[k]
                    for g in gloo for j in ("replicated", "sharded", "pmgt_ncf"))
                + nccl["sharded"]["train_launches"][k] + nccl["sharded"]["eval_export_launches"][k]
                + eng["launches"][k]
                + sum(g["study_launches"][k] for g in gloo if "study_launches" in g)
                + sum(t.get("rerun_launches", {}).get(k, 0) for r in study_results.values()
                      for t in r["trials"])
                for k in ("k1", "k2")}
    return {"lines": lines, "summary": summary, "launches": launches, "studies": study_results}


def torch_equal(a: dict, b: dict) -> bool:
    import torch

    return all(torch.equal(a[k], b[k]) for k in a)


def run_multi_card(root: str) -> dict:
    """``--multi-card`` (on a host with more than one card): the PMGT jobs
    of phase 21 (full-width train-pmgt, replicated and with both shard
    flags) at 2 and 4 NCCL ranks, one card each, against one rank in this
    process, with phase 21's bounds."""
    import shutil

    import torch

    from pmgt_tpu_torch.core import mesh
    from pmgt_tpu_torch.data.artifacts import save_native
    from pmgt_tpu_torch.data.synthetic import make_published_shape_dataset

    shutil.rmtree(root, ignore_errors=True)
    save_native(os.path.join(root, "TG"), make_published_shape_dataset("TG", seed=0))
    t = time.perf_counter()
    ref = multi_rank_work(root, root, MR_PMGT_JOBS, ())
    out = {"reference_s": time.perf_counter() - t, "ok": True}
    keys = ("job_s", "draw_ms", "epoch_ms", "step_ms", "all_reduce_ms_per_step",
            "row_gather_ms_per_step", "eval_export_ms", "train_launches", "eval_export_launches")
    for n in (2, 4):
        if n > torch.cuda.device_count():
            continue
        t = time.perf_counter()
        got = mesh.launch(multi_rank_work, n, (root, root, MR_PMGT_JOBS, ()), device="cuda",
                          backend="nccl", timeout_s=400, run_timeout_s=400)
        out[f"nccl{n}_launch_s"] = time.perf_counter() - t
        for name, _ in MR_PMGT_JOBS:
            checks = [_mr_close(ref[name], g[name]) for g in got]
            line = {"phase": "multi_card", "job": f"pmgt_{name}", "backend": "nccl", "ranks": n,
                    "checks": checks,
                    "params_bit_equal_across_ranks": all(
                        torch_equal(got[0][name]["params"], g[name]["params"]) for g in got[1:]),
                    "per_rank": [{"card": g["card"], **{k: g[name][k] for k in keys}} for g in got],
                    "reference": {k: ref[name][k] for k in keys}}
            line["ok"] = all(c["ok"] for c in checks) and line["params_bit_equal_across_ranks"]
            out["ok"] &= line["ok"]
            emit(line)
            out[f"nccl{n}_{name}"] = line
    return out


MULTI_CARD_JOBS = ("pmgt", "studies", "scale")


def multi_card_main(jobs=MULTI_CARD_JOBS) -> int:
    """``python3 chip_smoke.py --multi-card [pmgt] [studies] [scale]``:
    phase 21's PMGT jobs (``run_multi_card``), the hp-tuning command
    (``run_multi_card_studies``) and the 2,500,000-node sharded run
    (``run_multi_card_scale``); all three when none is named."""
    sys.path.insert(0, HERE)
    import torch

    if torch.cuda.device_count() < 2:
        print("--multi-card needs more than one card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    print(smi, flush=True)
    from pmgt_tpu_torch.ops import build

    build.build_all()
    root = os.path.join(HERE, "outputs", "chip_smoke_multi_card")
    out = run_multi_card(root) if "pmgt" in jobs else {"ok": True}
    studies = run_multi_card_studies(root) if "studies" in jobs else {"ok": True}
    scale = run_multi_card_scale() if "scale" in jobs else {"ok": True}
    emit({"phase": "multi_card", "cards": smi, "jobs": list(jobs),
          **{k: v for k, v in out.items() if k.endswith("_s")},
          **{k: v for k, v in studies.items() if k.endswith("_s")},
          "command_s": time.perf_counter() - T_START,
          "ok": out["ok"] and studies["ok"] and scale["ok"]})
    return 0 if out["ok"] and studies["ok"] and scale["ok"] else 1


def run_options(data_dir: str, root: str) -> dict:
    """Short ``train-pmgt`` runs at the default width (hidden 128, 5
    layers, batch 256), one epoch of 4 steps (``--valid-size 0.9``: 1,083
    training nodes), with ``--no-ctx-cache``, ``--gradient-checkpointing``
    (K1 = 2·L and K2 = L a step), ``--position-embedding-type
    relative_key`` (K1 = K2 = 0, as in JAX: relative layers take the plain
    attention), ``--feat-tables-dtype int8`` and ``--profile-dir`` (the
    trace file exists). Then step-1 gradients with and without
    checkpointing, f32, from the same weights and draws: within
    1e-6·max|g| + 1e-10 per parameter, and K1 = 2·L, K2 = L for that
    step."""
    import shutil

    import torch

    from pmgt_tpu_torch.tasks import pmgt_task
    from pmgt_tpu_torch.train.registry import RunRegistry

    shutil.rmtree(root, ignore_errors=True)
    common = ["--dataset-name", "TG", "--data-dir", data_dir, "--model-name", "pmgt",
              "--early-criterion", "auc", "--seed", "0", "--valid-size", "0.9",
              "--num-epochs", "1"]
    prof = os.path.join(root, "profile")
    cases = {"no_ctx_cache": ["--no-ctx-cache"],
             "gradient_checkpointing": ["--gradient-checkpointing"],
             "relative_key": ["--position-embedding-type", "relative_key"],
             "int8_tables": ["--feat-tables-dtype", "int8"],
             "profile_dir": ["--profile-dir", prof]}
    invocations, results, statuses = {}, {}, {}
    for label, extra in cases.items():
        log_dir = os.path.join(root, f"logs_{label}")
        results[label] = cli_invoke(["--device", "cuda", "train-pmgt", *common, "--log-dir",
                                     log_dir, *extra], invocations, label)
        (run,) = RunRegistry(log_dir).list_runs()
        statuses[label] = run.status

    args = args_of(["train-pmgt", *common])
    ctx = {"device": "cuda"}
    pmgt_task.init_dataloader(args, ctx)
    steps = len(ctx["train_nodes"]) // 256
    chunks = math.ceil(len(ctx["valid_nodes"]) / 256)
    layers = 5
    none = {"k1": 0, "k2": 0, "k3": 0, "k4": 0}
    plain = {**none, "k1": layers * (steps + 2 * chunks), "k2": layers * steps}
    want = {"no_ctx_cache": plain, "int8_tables": plain, "profile_dir": plain,
            "gradient_checkpointing": {**none, "k1": layers * (2 * steps + 2 * chunks),
                                       "k2": layers * steps},
            "relative_key": none}

    # step-1 gradients with and without checkpointing (f32)
    tasks = {}
    for remat in (False, True):
        a = args_of(["train-pmgt", *common, *(["--gradient-checkpointing"] if remat else [])])
        tasks[remat] = pmgt_task.PMGTTask(a, ctx["artifacts"], ctx["train_nodes"],
                                          ctx["valid_nodes"], device="cuda")
    tasks[True].model.load_state_dict(tasks[False].model.state_dict())
    tasks[False].on_epoch_start(0)
    tasks[True]._train_ctx = tasks[False]._train_ctx
    tasks[True]._train_ctx_tag = tasks[False]._train_ctx_tag
    grads, step_launches = {}, {}
    for remat, t in tasks.items():
        targets, gen = next(t.train_batches(0))
        torch.cuda.synchronize()
        zero_launches()
        t.accumulate_gradients(targets, gen)
        torch.cuda.synchronize()
        step_launches[remat] = read_launches()
        grads[remat] = {n: p.grad.detach().clone() for n, p in t.model.named_parameters()}
    worst = 0.0
    for n, g in grads[False].items():
        err = (grads[True][n] - g).abs().max().item()
        worst = max(worst, err / (1e-6 * g.abs().max().item() + 1e-10))
    trace = [f for f in os.listdir(prof)] if os.path.isdir(prof) else []
    checks = {
        "statuses_finished": all(v == "FINISHED" for v in statuses.values()),
        "metrics_finite": all(np.isfinite(list(r.values())).all() for r in results.values()),
        "launches": all(invocations[k]["launches"] == w for k, w in want.items()),
        "profile_trace_written": any(f.endswith(".pt.trace.json") for f in trace),
        "remat_step1_grads_within_1e-6": worst <= 1.0,
        "remat_step_launches": step_launches[True] == {**none, "k1": 2 * layers, "k2": layers}
        and step_launches[False] == {**none, "k1": layers, "k2": layers},
    }
    row = {"phase": "options", "steps": steps, "eval_chunks": chunks,
           "invocations": invocations, "expected_launches": want, "test": results,
           "profile_files": trace, "remat_step1_grad_err_over_limit": worst,
           "step_launches": {"gradient_checkpointing": step_launches[True],
                             "plain": step_launches[False]},
           "checks": checks, "ok": all(checks.values())}
    emit(row)
    if not row["ok"]:
        raise RuntimeError(f"options failed: {checks}")
    return row


# ---- the data and tuning commands: preprocess and hp-tuning -----------------

# The seeded review dump of the preprocess phase, sized to give a TG-sized
# co-review graph at min_common_users 3 (TG: 10,834 nodes, 38,252 edges):
# 12,000 items in communities of 8, 150,000 reviewers, 940,000 reviews
# before 2015-01-01 and 60,000 after it. The post-cutoff interactions (~56k
# over graph items) are cut from TG's 378k pairs, so that an hp-tuning
# trial's epoch takes seconds at batch 32.
DUMP = {"items": 12_000, "reviewers": 150_000, "pre_reviews": 940_000,
        "post_reviews": 60_000, "community": 8}
REVIEWS = "REVIEWS"  # the preprocessed dataset's name


def write_review_dump(raw_dir: str, items: int, reviewers: int, pre_reviews: int,
                      post_reviews: int, community: int, seed: int = 0) -> dict:
    """A gzipped review dump in the Amazon 5-core layout (one JSON object a
    line: reviewerID, asin, unixReviewTime, reviewText, overall) from
    ``seed``. Each reviewer has a home community of ``community`` items
    (popularity ∝ 1/rank^0.8 inside it) and lognormal(0, 1) activity; a
    review picks from the home community with probability 0.88, else from
    all items by lognormal(0, 1.5) popularity. Timestamps are uniform over
    2010–2014 for ``pre_reviews`` and over 2015–2017 for ``post_reviews``."""
    import gzip

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    home = rng.integers(0, items // community, reviewers)
    activity = rng.lognormal(0.0, 1.0, reviewers)
    activity /= activity.sum()
    within = 1.0 / np.arange(1, community + 1) ** 0.8
    within /= within.sum()
    popularity = rng.lognormal(0.0, 1.5, items)
    popularity /= popularity.sum()
    cutoff = 1_420_070_400  # 2015-01-01 UTC

    def draw(n, lo, hi):
        users = rng.choice(reviewers, n, p=activity)
        item = home[users] * community + rng.choice(community, n, p=within)
        away = rng.random(n) >= 0.88
        item[away] = rng.choice(items, int(away.sum()), p=popularity)
        return users, item, rng.integers(lo, hi, n), rng.integers(1, 6, n)

    words = ("fun", "great", "toy", "broke", "kids", "love", "cheap", "gift")
    lines = []
    for users, item, ts, stars in (draw(pre_reviews, 1_262_304_000, cutoff),
                                   draw(post_reviews, cutoff, 1_514_764_800)):
        for u, i, t, r in zip(users.tolist(), item.tolist(), ts.tolist(), stars.tolist()):
            lines.append(f'{{"reviewerID": "A{u:013d}", "asin": "B{i:09d}", '
                         f'"unixReviewTime": {t}, "reviewText": "{words[(u + i) % 8]} '
                         f'{words[(u * 7 + i) % 8]}", "overall": {r}.0}}')
    os.makedirs(raw_dir, exist_ok=True)
    path = os.path.join(raw_dir, "reviews.json.gz")
    with gzip.open(path, "wt", compresslevel=1) as f:
        f.write("\n".join(lines) + "\n")
    return {"reviews": len(lines), "pre_reviews": pre_reviews, "post_reviews": post_reviews,
            "items": items, "reviewers": reviewers, "bytes": os.path.getsize(path),
            "write_s": time.perf_counter() - t0}


def run_preprocess(root: str, dump: dict, min_nodes: int = 10_000) -> dict:
    """``preprocess`` through ``main()`` on a seeded review dump: counts,
    each stage's host time; the native pair counter against the scipy
    product and the native alias builder against the Python loop on the
    run's own inputs (identical edges, bit-equal tables), each timed;
    ``load_artifacts`` reading the result back; then a second run with
    seeded ``<dataset>_{visual,textual}_feats.npz`` and
    ``--extract-features``, whose seeded rows equal the files' and whose
    other rows equal the first run's. The graph must have at least
    ``min_nodes`` nodes."""
    import logging
    import shutil

    from pmgt_tpu_torch import native
    from pmgt_tpu_torch.cli.main import main as cli_main
    from pmgt_tpu_torch.data.artifacts import load_artifacts
    from pmgt_tpu_torch.data.preprocess import co_review_edges_scipy
    from pmgt_tpu_torch.graph.container import build_alias_tables_python

    shutil.rmtree(root, ignore_errors=True)
    raw, out, out2 = (os.path.join(root, d) for d in ("raw", "data", "data_seeded"))
    written = write_review_dump(raw, **dump)

    # the run's own inputs of the two native builders, and its stage times
    seen, stages = {}, {}
    real_count, real_alias = native.co_review_edges_native, native.build_alias_tables_native

    def count(items, users, min_common, max_pairs=2_000_000_000):
        seen["pairs"] = (items, users, min_common)
        return real_count(items, users, min_common, max_pairs)

    def alias(logits, degrees):
        seen["alias"] = (logits, degrees)
        return real_alias(logits, degrees)

    class StageLog(logging.Handler):
        def emit(self, record):
            stages.update(getattr(record, "stage_seconds", {}))

    handler, log = StageLog(), logging.getLogger("pmgt_tpu_torch")
    argv = ["preprocess", "--raw-dir", raw, "--dataset-name", REVIEWS]
    native.co_review_edges_native, native.build_alias_tables_native = count, alias
    log.addHandler(handler)
    try:
        zero_launches()
        t = time.perf_counter()
        art = cli_main([*argv, "--out-dir", out])
        wall = time.perf_counter() - t
        launches = read_launches()
    finally:
        native.co_review_edges_native, native.build_alias_tables_native = real_count, real_alias
        log.removeHandler(handler)

    items, users, min_common = seen["pairs"]
    t = time.perf_counter()
    nat = real_count(items, users, min_common)
    native_s = time.perf_counter() - t
    t = time.perf_counter()
    sci = co_review_edges_scipy(items, users, int(items.max()) + 1, int(users.max()) + 1,
                                min_common)
    scipy_s = time.perf_counter() - t

    def edge_rows(e):
        a = np.stack([np.asarray(x, np.int64) for x in e], 1)
        return a[np.lexsort((a[:, 1], a[:, 0]))]

    logits, degrees = seen["alias"]
    t = time.perf_counter()
    prob_n, idx_n = real_alias(logits, degrees)
    alias_native_s = time.perf_counter() - t
    t = time.perf_counter()
    prob_p, idx_p = build_alias_tables_python(logits, degrees)
    alias_python_s = time.perf_counter() - t

    t = time.perf_counter()
    back = load_artifacts(out, REVIEWS)
    load_s = time.perf_counter() - t

    # the drop-in feature files: every third node's visual row, every
    # fifth node's textual row, and one asin that is no node
    nodes = [str(a) for a in art.node_classes]
    rng = np.random.default_rng(1)
    os.makedirs(out2, exist_ok=True)
    seeded = {}
    for modality, dim, picked in (("visual", 1536, nodes[::3]), ("textual", 768, nodes[::5])):
        feats = rng.normal(size=(len(picked) + 1, dim)).astype(np.float32)
        np.savez_compressed(os.path.join(out2, f"{REVIEWS}_{modality}_feats.npz"), feats=feats,
                            asins=np.asarray(picked + ["B_NOT_A_NODE"], dtype=object))
        seeded[modality] = (picked, feats)
    t = time.perf_counter()
    art2 = cli_main([*argv, "--out-dir", out2, "--extract-features"])
    seeded_wall = time.perf_counter() - t
    fills = {}
    for m, (modality, (picked, feats)) in enumerate(seeded.items()):
        rows = np.zeros(art.num_nodes + 2, bool)
        rows[2 + np.arange(art.num_nodes)[::3 if modality == "visual" else 5]] = True
        table, base = art2.feat_init_embs[m], art.feat_init_embs[m]
        fills[modality] = (bool(np.array_equal(table[rows], feats[:-1]))
                           and bool(np.array_equal(table[~rows], base[~rows])))

    checks = {
        "native_equals_scipy_edges": bool(np.array_equal(edge_rows(nat), edge_rows(sci))),
        "native_alias_equals_python": bool(np.array_equal(prob_n, prob_p)
                                           and np.array_equal(idx_n, idx_p)),
        "graph_uses_the_native_tables": bool(np.array_equal(art.graph.alias_prob, prob_n)
                                             and np.array_equal(art.graph.alias_idx, idx_n)),
        "at_least_min_nodes": art.num_nodes >= min_nodes,
        "load_artifacts_reads_it_back":
            back.num_nodes == art.num_nodes
            and bool(np.array_equal(back.graph.alias_prob, art.graph.alias_prob))
            and bool(np.array_equal(back.train_pairs, art.train_pairs))
            and bool(np.array_equal(back.feat_init_embs[0], art.feat_init_embs[0]))
            and list(back.item_classes) == list(art.item_classes),
        "seeded_rows_filled_exactly": all(fills.values()),
        "no_kernel_launched": not any(launches.values()),
    }
    row = {
        "phase": "preprocess", "dump": written,
        "nodes": art.num_nodes, "edges": int(art.graph.degrees.sum()) // 2,
        "max_degree": art.graph.max_degree, "users": art.num_users, "items": art.num_items,
        "train_pairs": len(art.train_pairs), "test_pairs": len(art.test_pairs),
        "graph_pairs": len(items), "command_s": wall, "stage_s": stages,
        "count_pairs_native_s": native_s, "count_pairs_scipy_s": scipy_s,
        "alias_native_s": alias_native_s, "alias_python_s": alias_python_s,
        "load_artifacts_s": load_s, "seeded_command_s": seeded_wall, "launches": launches,
        "checks": checks, "ok": all(checks.values()),
    }
    emit(row)
    if not row["ok"]:
        raise RuntimeError(f"preprocess failed: {checks}")
    return {"row": row, "data_dir": out, "art": art}


def tune(argv) -> list:
    """``hp-tuning`` with ``argv`` as the command runs it (its parser,
    ``hpo.study_spec`` and ``hpo.launch_study``): each rank's ``run_study``
    result, whose trial records carry the state, value, seconds, kernel
    launches (read inside the rank before and after each trial), pruning
    answers and the card's allocated bytes after ``gc.collect()``."""
    from pmgt_tpu_torch.cli import hpo
    from pmgt_tpu_torch.cli.main import build_parser

    return hpo.launch_study(hpo.study_spec(build_parser().parse_args(argv)))


def allocated() -> int:
    """The card's allocated bytes after a garbage collection."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def trial_runs(log_dir: str) -> dict:
    """{trial number: (run, its val metrics by name, epoch times)} of the
    runs an hp-tuning study logged under ``log_dir``."""
    from pmgt_tpu_torch.train.registry import RunRegistry

    out = {}
    for run in RunRegistry(log_dir).list_runs():
        with open(os.path.join(run.run_dir, "tags.json")) as f:
            tags = json.load(f)
        metrics = {}
        for m in run.metrics():
            metrics.setdefault(m["name"], []).append(m["value"])
        out[int(tags["trial"])] = (run, metrics, tags)
    return out


def run_hpo_pmgt(data_dir: str, root: str, art) -> dict:
    """``hp-tuning --train-name pmgt`` with config/hpo/hpo_pmgt_params.yaml
    and a copy of config/hpo/train_pmgt_params.json that changes only
    ``data_dir``, ``dataset_name`` and ``log_dir`` and cuts a trial to
    ``STUDY_TRAIN``'s one short epoch: 2 trials, then the same study
    resumed to 3 (exactly one more trial), through ``tune`` (the command's
    parser and launch; the trial records are the port's). Per
    trial: FINISHED, its objective equal to its logged ``val/auc`` within
    1e-6 (1 epoch: the best), K2 = L a step and K1 = L a step + L an
    evaluation chunk (the epoch's validation and the HPO test, which
    evaluates the validation split), and the card's allocated memory back
    within 16 MB of its value before the first trial."""
    import shutil

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    with open(os.path.join(HERE, "config", "hpo", "train_pmgt_params.json")) as f:
        cfg = json.load(f)
    log_dir = os.path.join(root, "logs")
    cfg.update(data_dir=data_dir, dataset_name=REVIEWS, log_dir=log_dir, **STUDY_TRAIN)
    train_path = os.path.join(root, "train_pmgt_params.json")
    with open(train_path, "w") as f:
        json.dump(cfg, f, indent=2)
    argv = ["--device", "cuda", "hp-tuning", "--hp-config-path",
            os.path.join(HERE, "config", "hpo", "hpo_pmgt_params.yaml"),
            "--train-config-path", train_path, "--train-name", "pmgt",
            "--study-name", "pmgt-study", "--storage-path", os.path.join(root, "hpo", "db")]
    base = {"memory": allocated()}
    zero_launches()
    t = time.perf_counter()
    (first_run,) = tune([*argv, "--n-trials", "2"])
    first_s, first = time.perf_counter() - t, len(first_run["trials"])
    (second_run,) = tune([*argv, "--n-trials", "3"])
    total = read_launches()
    records = first_run["trials"] + second_run["trials"]
    with open(os.path.join(root, "hpo", "pmgt-study_trials.json")) as f:
        stored = json.load(f)

    n_valid = math.ceil(cfg["valid_size"] * art.num_nodes)
    steps = (art.num_nodes - n_valid) // cfg["train_batch_size"]
    chunks = math.ceil(n_valid / cfg["test_batch_size"])
    runs = trial_runs(log_dir)
    none = {"k1": 0, "k2": 0, "k3": 0, "k4": 0}
    trials, ok_trials = [], []
    for rec in records:
        run, metrics, tags = runs[rec["number"]]
        layers = int(run.params["num_hidden_layers"])
        want = {**none, "k1": layers * (steps + 2 * chunks), "k2": layers * steps}
        auc = metrics.get("val/auc", [])
        trial = {
            "phase": "hpo_pmgt_trial", "number": rec["number"], "state": rec["state"],
            "objective": rec["value"], "wall_s": rec["seconds"], "launches": rec["launches"],
            "params": rec["params"], "memory_allocated": rec["memory_allocated"],
            "run_status": run.status,
            "hidden_size": run.params["hidden_size"], "num_hidden_layers": layers,
            "beta": run.params["beta"], "lr": run.params["lr"],
            "mask_node_ratio": run.params["mask_node_ratio"],
            "epoch_s": metrics.get("epoch_time"), "val_auc": auc,
            "expected_launches": want,
            "memory_over_base_bytes": rec["memory_allocated"] - base["memory"],
        }
        trial["checks"] = {
            "finished": run.status == "FINISHED" and rec["state"] == "COMPLETE",
            "objective_is_logged_val_auc": len(auc) == 1
            and abs(rec["value"] - auc[0]) <= 1e-6,
            "launches": rec["launches"] == want,
            "memory_within_16MB": abs(trial["memory_over_base_bytes"]) <= 16 << 20,
            "tagged": tags.get("study_name") == "pmgt-study",
        }
        emit(trial)
        trials.append(trial)
        ok_trials.append(all(trial["checks"].values()))
    checks = {
        "trials": ok_trials == [True] * 3,
        "resume_adds_one": first == 2 and len(records) == 3
        and [t["number"] for t in stored] == [0, 1, 2]
        and all(t["state"] == "COMPLETE" for t in stored),
        "stored_objectives": [t["value"] for t in stored] == [r["value"] for r in records],
        "launches_are_the_trials": total == {k: sum(r["launches"][k] for r in records)
                                              for k in none},
    }
    row = {"phase": "hpo_pmgt", "steps_per_epoch": steps, "eval_chunks": chunks,
           "first_two_trials_s": first_s, "memory_base_bytes": base["memory"],
           "launches": total,
           "checks": checks, "ok": all(checks.values())}
    emit(row)
    if not row["ok"]:
        raise RuntimeError(f"hp-tuning (PMGT) failed: {checks}")
    return {"row": row, "trials": trials}


def run_hpo_ncf(data_dir: str, root: str, art) -> dict:
    """``hp-tuning --train-name ncf --enable-trial-pruning`` with
    config/hpo/hpo_ncf_neumf_pmgt_params.yaml (NeuMF-PMGT, with ``prune:
    true`` arms) and a copy of config/hpo/train_ncf_neumf_pmgt_params.json
    (``data_dir``, ``dataset_name``, ``log_dir``, ``num_epochs`` 1, and its
    ``item_init_emb_path``); the space's batch pinned to its largest
    choice, 256 (a draw of 32 takes ~2,800 steps), and its three
    ``node_feat*_{32,64,128}dim.npy`` statics rewritten to exports of the preprocessed dataset made
    here by ``train-pmgt`` (hidden 32, 64, 128; 2 layers; one short epoch)
    and ``--mode inference``, so the ``classes.npz`` node-to-item remap runs
    on the card. 2 trials: 2 COMPLETE in the trials JSON, every trial that
    drew a prune arm PRUNED and no other, ``should_prune`` asked once an
    epoch and never True (the built-in study), each COMPLETE objective
    equal to its logged ``val/n20``."""
    import shutil

    from pmgt_tpu_torch.cli import hpo
    from pmgt_tpu_torch.data.artifacts import load_node_init_emb
    from pmgt_tpu_torch.train.registry import RunRegistry

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    invocations, exports, remap = {}, {}, {}
    for h in (32, 64, 128):
        log_dir = os.path.join(root, f"pmgt_logs_{h}")
        common = ["--device", "cuda", "train-pmgt", "--model-name", "PMGT",
                  "--dataset-name", REVIEWS,
                  "--data-dir", data_dir, "--log-dir", log_dir, "--early-criterion", "auc",
                  "--hidden-size", str(h), "--intermediate-size", str(h),
                  "--num-hidden-layers", "2", "--test-batch-size", "1024"]
        cli_invoke([*common, "--num-epochs", "1", "--valid-size", "0.9"], invocations,
                   f"train_pmgt_{h}")
        (run,) = RunRegistry(log_dir).list_runs()
        exports[h] = os.path.join(root, f"node_feat_{h}dim.npy")
        cli_invoke([*common, "--mode", "inference", "--run-id", run.run_id,
                    "--inference-result-path", exports[h]], invocations, f"export_{h}")
        emb = np.load(exports[h])
        items = load_node_init_emb(art.item_classes, art.node_classes, emb)
        remap[h] = {"export_shape": list(emb.shape), "finite": bool(np.isfinite(emb).all()),
                    "item_table_shape": list(items.shape)}

    with open(os.path.join(HERE, "config", "hpo", "hpo_ncf_neumf_pmgt_params.yaml")) as f:
        space = f.read()
    for h, name in ((32, "node_feat4_32dim"), (64, "node_feat6_64dim"),
                    (128, "node_feat5_128dim")):
        space = space.replace(f"./data/VG/{name}.npy", exports[h])
    batch = "train_batch_size:\n  type: categorical\n  value: [32, 64, 128, 256]"
    if space.count(batch) != 1:
        raise RuntimeError("the published NeuMF-PMGT space changed")
    space = space.replace(batch, batch.replace("[32, 64, 128, 256]", "[256]"))
    space_path = os.path.join(root, "hpo_ncf_neumf_pmgt_params.yaml")
    with open(space_path, "w") as f:
        f.write(space)
    with open(os.path.join(HERE, "config", "hpo", "train_ncf_neumf_pmgt_params.json")) as f:
        cfg = json.load(f)
    log_dir = os.path.join(root, "logs")
    cfg.update(data_dir=data_dir, dataset_name=REVIEWS, log_dir=log_dir, num_epochs=1,
               item_init_emb_path=exports[32])
    train_path = os.path.join(root, "train_ncf_neumf_pmgt_params.json")
    with open(train_path, "w") as f:
        json.dump(cfg, f, indent=2)

    base = allocated()
    (study,) = tune(["--device", "cuda", "hp-tuning", "--hp-config-path", space_path,
                     "--train-config-path", train_path, "--train-name", "ncf",
                     "--study-name", "ncf-pmgt-study", "--storage-path",
                     os.path.join(root, "hpo", "db"), "--n-trials", "2",
                     "--enable-trial-pruning"])
    records = study["trials"]
    complete = [r for r in records if r["state"] == "COMPLETE"]
    with open(os.path.join(root, "hpo", "ncf-pmgt-study_trials.json")) as f:
        stored = json.load(f)

    parsed = hpo._load_space(space_path)
    runs = trial_runs(log_dir)
    trials, prune_ok, objective_ok = [], [], []
    for rec in stored:
        try:
            hpo.get_hp_params(Replay(rec["params"]), parsed)
            arm = False
        except hpo.TrialPruned:
            arm = True
        prune_ok.append(arm == (rec["state"] == "PRUNED"))
        watched = next(r for r in records if r["number"] == rec["number"])
        trial = {"phase": "hpo_ncf_trial", **{k: v for k, v in watched.items() if k != "results"},
                 "prune_arm": arm}
        if rec["state"] == "COMPLETE":
            run, metrics, _ = runs[rec["number"]]
            n20 = metrics.get("val/n20", [])
            trial.update(run_status=run.status, val_n20=n20, epoch_s=metrics.get("epoch_time"),
                         factor_num=run.params["factor_num"],
                         num_layers=run.params["num_layers"],
                         train_batch_size=run.params["train_batch_size"],
                         item_init_emb_path=os.path.basename(run.params["item_init_emb_path"]))
            objective_ok.append(run.status == "FINISHED" and len(n20) == 1
                                and abs(rec["value"] - n20[0]) <= 1e-6)
        emit(trial)
        trials.append(trial)
    n_complete = sum(r["state"] == "COMPLETE" for r in stored)
    checks = {
        "exports": all(r["export_shape"] == [art.num_nodes, h] and r["finite"]
                       and r["item_table_shape"] == [art.num_items, h]
                       for h, r in remap.items()),
        "two_complete": n_complete == 2,
        "pruned_arms_recorded_as_pruned": all(prune_ok),
        "should_prune_asked_each_epoch_never_true": len(complete) == n_complete
        and all(r["pruning_answers"] == [False] for r in complete),
        "objective_is_logged_val_n20": len(objective_ok) == 2 and all(objective_ok),
        "no_kernel_in_ncf_trials": not any(v for r in complete for v in r["launches"].values()),
    }
    row = {"phase": "hpo_ncf", "exports": remap, "export_invocations": invocations,
           "trials_json_states": [r["state"] for r in stored],
           "should_prune_answers": [r["pruning_answers"] for r in complete],
           "memory_base_bytes": base,
           "memory_over_base_bytes": [r["memory_allocated"] - base for r in complete],
           "checks": checks, "ok": all(checks.values())}
    emit(row)
    if not row["ok"]:
        raise RuntimeError(f"hp-tuning (NCF) failed: {checks}")
    return {"row": row, "trials": trials, "space_path": space_path, "cfg": cfg}


# ---- hp-tuning studies over several ranks -------------------------------------

# A study's trials: one short epoch (valid 0.9: 1,200 of the 12,000 nodes
# train, 37 steps of 32) and evaluation chunks of 1,024 (11 chunks).
STUDY_TRAIN = {"num_epochs": 1, "valid_size": 0.9, "test_batch_size": 1024}


def write_study_space(path: str) -> str:
    """config/hpo/hpo_pmgt_params.yaml drawing at full width: hidden 128
    (intermediate 128 by its own arm) and 3–5 layers; lr, β and the mask
    ratio as published."""
    with open(os.path.join(HERE, "config", "hpo", "hpo_pmgt_params.yaml")) as f:
        text = f.read()
    for old, new in (("value: [32, 64, 128]", "value: [128]"), ("value: [2, 5]", "value: [3, 5]")):
        if text.count(old) != 1:
            raise RuntimeError(f"the published PMGT space changed: {old!r}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return path


def pmgt_study_config(data_dir: str, dataset: str, log_dir: str, **extra) -> dict:
    """config/hpo/train_pmgt_params.json (bf16, batch 32) on ``dataset``,
    cut to ``STUDY_TRAIN``."""
    with open(os.path.join(HERE, "config", "hpo", "train_pmgt_params.json")) as f:
        cfg = json.load(f)
    cfg.update(data_dir=data_dir, dataset_name=dataset, log_dir=log_dir, **STUDY_TRAIN, **extra)
    return cfg


def make_study_spec(train_name: str, cfg: dict, space_path: str, n_trials: int, name: str,
                    storage_dir: str, pruning: bool = False):
    """The ``hpo.StudySpec`` the ``hp-tuning`` command would build."""
    from pmgt_tpu_torch.cli import hpo

    cfg = {**cfg, "tags": list(cfg.get("tags", [])) + [["study_name", name]]}
    os.makedirs(storage_dir, exist_ok=True)
    return hpo.StudySpec(train_name, cfg, hpo._load_space(space_path), n_trials, name,
                         os.path.join(storage_dir, "db"), pruning, "cuda")


def pmgt_trial_launches(num_nodes: int, cfg: dict, layers: int) -> dict:
    """K1 / K2 of one PMGT trial on each rank: L a step; K1 also L an
    evaluation chunk, over the epoch's validation and the HPO test (both
    on the validation split)."""
    from pmgt_tpu_torch.tools.cli_runner import pmgt_run_launches

    return pmgt_run_launches(num_nodes, cfg["valid_size"], cfg["train_batch_size"],
                             cfg["test_batch_size"], layers, 1)


class Replay:
    """A trial's recorded draws, replayed through the space."""

    def __init__(self, params):
        self.params = params

    def suggest_categorical(self, name, choices):
        return self.params[name]

    def suggest_float(self, name, *args, **kwargs):
        return self.params[name]

    suggest_int = suggest_float


def rerun_one_rank(train_name: str, spec, params: dict, log_dir: str, **extra) -> dict:
    """A trial's recorded parameters as a 1-rank trial in this process
    (``extra``: ``mode="eval"`` and the trial's ``run_id`` evaluate its
    best checkpoint instead): its test results, launches and wall time."""
    from pmgt_tpu_torch.cli import hpo
    from pmgt_tpu_torch.cli.main import train_args, train_model

    raw = {**spec.train_params, **hpo.get_hp_params(Replay(params), spec.hp_params),
           "num_devices": 1, "log_dir": log_dir, **extra}
    zero_launches()
    results, ms = timed(lambda: train_model(train_name, train_args(raw), device="cuda",
                                            is_hptuning=True))
    return {"results": results, "launches": read_launches(), "s": ms / 1e3}


def check_study(phase: str, name: str, spec, ranks: list, rerun_root: str, num_nodes: int,
                memory_base=None) -> dict:
    """A study that ran on several ranks. ``ranks``: each rank's list of
    ``run_study`` results (a first run, then its resumes). Checks: every
    rank trained the trials rank 0's study stored, in order, with equal
    test results; each COMPLETE trial a FINISHED run, once, its objective
    its logged ``val/<criterion>`` (1e-6), a 1-rank evaluation of its own
    best checkpoint in this process (PMGT AUC within 1e-5; NCF n20 and r20
    equal), and a 1-rank re-run of its training here within 2e-3 of AUC
    (PMGT) or of n20 and r20 (NCF). N ranks train like one only to
    rounding: each rank's partial gradients are summed, in bf16 under the
    PMGT policy (each rank rounds its weight gradients to bf16 first, as
    XLA does on a mesh) and in another order in f32, and over an epoch
    Adam amplifies the difference (measured on the H100, PERF.md §6: up
    to 3.1e-4 of AUC, 2.5e-4 of r20); PRUNED trials
    trained nowhere; per rank, PMGT K1/K2 launches as predicted (NCF:
    none), pruning asked once an epoch on every rank exactly when pruning
    is on, and the card's allocated bytes after each trial within 16 MB
    of ``memory_base`` (that rank's level before the study; without it,
    of the first trial's level in the same launch). One line a trial, then
    the study's."""
    with open(os.path.join(os.path.dirname(spec.storage_path),
                           f"{spec.study_name}_trials.json")) as f:
        stored = {t["number"]: t for t in json.load(f)}
    from pmgt_tpu_torch.train.registry import RunRegistry

    runs = trial_runs(spec.train_params["log_dir"])
    counts = {}
    for run in RunRegistry(spec.train_params["log_dir"]).list_runs():
        with open(os.path.join(run.run_dir, "tags.json")) as f:
            number = int(json.load(f)["trial"])
        counts[number] = counts.get(number, 0) + 1
    crit = spec.criterion.split("/")[1]
    flat = [[t for r in runs_of_rank for t in r["trials"]] for runs_of_rank in ranks]
    same_trials = all([(t["number"], t["params"], t["state"]) for t in f] ==
                      [(t["number"], t["params"], t["state"]) for t in flat[0]] for f in flat)
    lines, ok = [], same_trials and len(flat[0]) == len(stored)
    for i, rec in enumerate(flat[0]):
        per_rank = [f[i] for f in flat]
        line = {"phase": f"{phase}_trial", "study": name, "number": rec["number"],
                "state": rec["state"], "params": rec["params"]}
        if rec["state"] == "PRUNED":
            line["checks"] = {"stored_pruned": stored[rec["number"]]["state"] == "PRUNED",
                              "trained_nowhere": all("seconds" not in r for r in per_rank)
                              and rec["number"] not in runs}
        else:
            run, metrics, _ = runs[rec["number"]]
            logged = metrics.get(f"val/{crit}", [])
            ref = rerun_one_rank(spec.train_name, spec, rec["params"],
                                 os.path.join(rerun_root, f"{name}_{rec['number']}"))
            evald = rerun_one_rank(spec.train_name, spec, rec["params"],
                                   spec.train_params["log_dir"], mode="eval", run_id=run.run_id)
            if spec.train_name == "pmgt":
                layers = int(rec["params"]["num_hidden_layers"])
                want = pmgt_trial_launches(num_nodes, spec.train_params, layers)
                keys = (spec.criterion,)
                eval_ok = abs(rec["value"] - evald["results"][spec.criterion]) <= 1e-5
            else:
                want = {"k1": 0, "k2": 0, "k3": 0, "k4": 0}
                keys = ("test/n20", "test/r20")
                eval_ok = all(rec["results"][k] == evald["results"][k] for k in keys)
            rerun_diff = max(abs(rec["results"][k] - ref["results"][k]) for k in keys)
            levels = [r["memory_allocated"] - (memory_base[j] if memory_base else
                                               flat[j][0]["memory_allocated"])
                      for j, r in enumerate(per_rank)]
            line.update(
                objective=rec["value"], results=rec["results"], logged=logged,
                one_rank_evaluation=evald["results"], rerun=ref["results"],
                rerun_max_abs_diff=rerun_diff,
                rerun_s=ref["s"], rerun_launches=ref["launches"], expected_launches=want,
                epoch_s=metrics.get("epoch_time"),
                ranks=[{"rank": j, "seconds": r["seconds"], "launches": r["launches"],
                        "memory_over_level_bytes": levels[j],
                        "pruning_answers": r["pruning_answers"]}
                       for j, r in enumerate(per_rank)])
            line["checks"] = {
                "finished_once": run.status == "FINISHED" and counts[rec["number"]] == 1,
                "stored": stored[rec["number"]]["state"] == "COMPLETE"
                and stored[rec["number"]]["value"] == rec["value"],
                "objective_is_logged": len(logged) == 1 and abs(rec["value"] - logged[0]) <= 1e-6,
                "equals_one_rank_evaluation": eval_ok,
                "one_rank_rerun_within_2e-3": rerun_diff <= 2e-3,
                "same_results_on_every_rank": all(r["results"] == rec["results"]
                                                  for r in per_rank),
                "launches_per_rank": all(r["launches"] == want for r in per_rank)
                and ref["launches"] == want,
                "pruning_asked_each_epoch_on_every_rank": all(
                    r["pruning_answers"] == ([False] * len(logged) if spec.enable_trial_pruning
                                             else []) for r in per_rank),
                "memory_back_within_16MB": all(abs(v) <= 16 << 20 for v in levels),
            }
        line["ok"] = all(line["checks"].values())
        ok &= line["ok"]
        emit(line)
        lines.append(line)
    row = {"phase": phase, "study": name, "ranks": len(ranks),
           "runs": [len(r["trials"]) for r in ranks[0]],
           "states": [t["state"] for t in flat[0]], "same_trials_on_every_rank": same_trials,
           "ok": bool(ok)}
    emit(row)
    return {"row": row, "trials": lines, "ok": bool(ok)}


def multi_rank_studies(data_dir: str, art, ncf_space: str, ncf_cfg: dict, root: str) -> list:
    """The studies of the multi_rank phase's gloo ranks, on phase 17's
    data: PMGT (``write_study_space``: hidden 128, 3–5 layers, bf16, batch
    32; ``STUDY_TRAIN``'s short epoch), 2 trials, then the study resumed
    to 3; NeuMF-PMGT (phase 19's space and train config) with pruning
    enabled, 1 COMPLETE trial."""
    import shutil

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    space = write_study_space(os.path.join(root, "hpo_pmgt_params.yaml"))
    cfg = pmgt_study_config(data_dir, REVIEWS, os.path.join(root, "pmgt_logs"))
    pmgt = [make_study_spec("pmgt", cfg, space, n, "pmgt-mr-study", os.path.join(root, "pmgt_hpo"))
            for n in (2, 3)]
    ncf = [make_study_spec("ncf", {**ncf_cfg, "log_dir": os.path.join(root, "ncf_logs")},
                           ncf_space, 1, "ncf-mr-study", os.path.join(root, "ncf_hpo"),
                           pruning=True)]
    return [("pmgt_study", pmgt, art.num_nodes), ("ncf_study", ncf, art.num_nodes)]


def run_multi_card_studies(root: str) -> dict:
    """``--multi-card``: the ``hp-tuning`` command (its parser and
    ``hpo.launch_study``, the command's own spawn) with ``num_devices`` 2
    and 4 in the train config, NCCL ranks a card each, on the TG-shape
    data of ``run_multi_card``: the PMGT study of the multi_rank phase, 2
    trials then a resume to 3, each trial checked by ``check_study``."""
    import shutil

    import torch

    from pmgt_tpu_torch.cli import hpo
    from pmgt_tpu_torch.cli.main import build_parser

    art = _mr_artifacts(root, "TG")
    space = write_study_space(os.path.join(root, "hpo_pmgt_params.yaml"))
    out = {"ok": True}
    for n in (2, 4):
        if n > torch.cuda.device_count():
            continue
        sroot = os.path.join(root, f"study_nccl{n}")
        shutil.rmtree(sroot, ignore_errors=True)
        os.makedirs(sroot)
        train = os.path.join(sroot, "train_pmgt_params.json")
        with open(train, "w") as f:
            json.dump(pmgt_study_config(root, "TG", os.path.join(sroot, "logs"), num_devices=n), f)
        argv = ["--device", "cuda", "hp-tuning", "--hp-config-path", space,
                "--train-config-path", train, "--train-name", "pmgt",
                "--study-name", f"pmgt-nccl{n}", "--storage-path", os.path.join(sroot, "hpo", "db")]
        runs, t = [], time.perf_counter()
        for k in (2, 3):
            ns = build_parser().parse_args([*argv, "--n-trials", str(k)])
            runs.append(hpo.launch_study(hpo.study_spec(ns)))
        out[f"nccl{n}_study_s"] = time.perf_counter() - t
        res = check_study("multi_card_study", f"pmgt_nccl{n}", hpo.study_spec(ns),
                          [[r[j] for r in runs] for j in range(n)],
                          os.path.join(sroot, "rerun"), art.num_nodes)
        out["ok"] &= res["ok"]
    return out


# ---- feature extraction at the published widths ---------------------------------

FX_ITEMS = 300  # items with 1–3 images and 1–3 reviews each


def standin_cnn():
    """A seeded stand-in for Inception-v4's timm surface, 1,536 wide:
    ``forward_features`` (conv 3→32, 8×8 stride 8, ReLU, 4×4 average pool,
    1×1 conv to 1,536) and ``global_pool`` (mean over the map)."""
    import torch

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            torch.manual_seed(0)
            self.stem = torch.nn.Conv2d(3, 32, 8, stride=8)
            self.head = torch.nn.Conv2d(32, 1536, 1)

        def forward_features(self, x):
            return self.head(torch.nn.functional.avg_pool2d(torch.relu(self.stem(x)), 4))

        def global_pool(self, x):
            return x.mean(dim=(2, 3))

    return Net()


def standin_text_model():
    """(encoder, tokenizer): a seeded stand-in for BERT-base's surface,
    768 wide. The tokenizer maps words to ids by CRC-32, adds [CLS] /
    [SEP], truncates to ``max_length`` and pads to the batch's longest;
    the encoder is an embedding, one 12-head masked self-attention layer
    and a feed-forward layer, each with a residual and LayerNorm, and
    returns ``last_hidden_state``."""
    import types
    import zlib

    import torch

    class Encoding(dict):
        def to(self, device):
            return Encoding({k: v.to(device) for k, v in self.items()})

    def tokenizer(texts, padding=True, truncation=True, max_length=128, return_tensors="pt"):
        ids = [[101] + [1000 + zlib.crc32(w.encode()) % 29000 for w in t.split()]
               [: max_length - 2] + [102] for t in texts]
        width = max(len(i) for i in ids)
        input_ids = torch.zeros((len(ids), width), dtype=torch.long)
        mask = torch.zeros((len(ids), width), dtype=torch.long)
        for r, row in enumerate(ids):
            input_ids[r, : len(row)] = torch.tensor(row)
            mask[r, : len(row)] = 1
        return Encoding(input_ids=input_ids, attention_mask=mask)

    class Encoder(torch.nn.Module):
        def __init__(self, width=768, heads=12):
            super().__init__()
            torch.manual_seed(1)
            self.heads = heads
            self.tok = torch.nn.Embedding(30522, width)
            self.pos = torch.nn.Embedding(512, width)
            self.qkv = torch.nn.Linear(width, 3 * width)
            self.out = torch.nn.Linear(width, width)
            self.ff = torch.nn.Sequential(torch.nn.Linear(width, 1024), torch.nn.GELU(),
                                          torch.nn.Linear(1024, width))
            self.ln1, self.ln2 = torch.nn.LayerNorm(width), torch.nn.LayerNorm(width)

        def forward(self, input_ids, attention_mask):
            b, n = input_ids.shape
            x = self.tok(input_ids) + self.pos(torch.arange(n, device=input_ids.device))
            q, k, v = (t.reshape(b, n, self.heads, -1).transpose(1, 2)
                       for t in self.qkv(x).chunk(3, dim=-1))
            scores = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
            scores = scores.masked_fill(attention_mask[:, None, None, :] == 0, float("-inf"))
            att = (scores.softmax(-1) @ v).transpose(1, 2).reshape(b, n, -1)
            x = self.ln1(x + self.out(att))
            return types.SimpleNamespace(last_hidden_state=self.ln2(x + self.ff(x)))

    return Encoder(), tokenizer


def run_feature_extraction(root: str) -> dict:
    """The extractors on the card at Inception-v4's and BERT-base's output
    widths, with stand-in models (the card machine has no timm,
    transformers or PIL): ``FX_ITEMS`` items of 1–3 seeded 3×299×299
    arrays through ``extract_visual_features`` (a numpy transform) and of
    1–3 seeded reviews (5–160 words) through ``extract_textual_features``
    (``max_length`` 128); every row against a CPU recomputation with the
    same models (TF32 off), within 1e-4. The rows are written with
    ``save_feats_npz`` and ``preprocess --extract-features`` on a seeded
    dump over the same asins fills exactly those rows. Times per 1,000
    images and per 1,000 reviews (host clock; each item's row is copied
    to the host, so the clock waits for the card)."""
    import shutil

    import torch

    from pmgt_tpu_torch.cli.main import main as cli_main
    from pmgt_tpu_torch.data import feature_extraction as fx

    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(0)
    asins = [f"B{i:09d}" for i in range(FX_ITEMS)]
    counts = rng.integers(1, 4, FX_ITEMS)
    images = [(a, [rng.standard_normal((3, 299, 299), dtype=np.float32) for _ in range(c)])
              for a, c in zip(asins, counts)]
    words = [f"w{i}" for i in range(5000)]
    texts = {a: [" ".join(rng.choice(words, rng.integers(5, 161)))
                 for _ in range(rng.integers(1, 4))] for a in asins}
    cnn, (encoder, tokenizer) = standin_cnn(), standin_text_model()

    def transform(a):
        return torch.from_numpy(a)

    out = {}
    for device in ("cuda", "cpu"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        vis = fx.extract_visual_features(images, model=cnn, transform=transform, device=device)
        visual_s = time.perf_counter() - t
        t = time.perf_counter()
        txt = fx.extract_textual_features(texts, model=encoder, tokenizer=tokenizer,
                                          device=device)
        out[device] = {"visual": vis, "textual": txt, "visual_s": visual_s,
                       "textual_s": time.perf_counter() - t}
    n_images, n_reviews = int(counts.sum()), sum(len(v) for v in texts.values())

    def diff(m):
        (a, ma), (b, mb) = out["cuda"][m], out["cpu"][m]
        return float(np.abs(a - b).max()) if ma == mb == asins else float("inf")

    # the drop-in files, consumed by preprocess on a dump over the same asins
    data = os.path.join(root, "data")
    os.makedirs(data)
    for m in ("visual", "textual"):
        fx.save_feats_npz(os.path.join(data, f"{REVIEWS}_{m}_feats.npz"), *out["cuda"][m])
    write_review_dump(os.path.join(root, "raw"), items=FX_ITEMS, reviewers=6000,
                      pre_reviews=40_000, post_reviews=3000, community=8)
    art = cli_main(["preprocess", "--raw-dir", os.path.join(root, "raw"), "--out-dir", data,
                    "--dataset-name", REVIEWS, "--extract-features"])
    nodes = [str(a) for a in art.node_classes]
    filled = all(
        np.array_equal(table[2:], feats[[asins.index(a) for a in nodes]])
        for table, (feats, _) in zip(art.feat_init_embs,
                                     (out["cuda"]["visual"], out["cuda"]["textual"])))
    checks = {
        "visual_shape": out["cuda"]["visual"][0].shape == (FX_ITEMS, 1536),
        "textual_shape": out["cuda"]["textual"][0].shape == (FX_ITEMS, 768),
        "visual_rows_within_1e-4_of_cpu": diff("visual") <= 1e-4,
        "textual_rows_within_1e-4_of_cpu": diff("textual") <= 1e-4,
        "finite": all(np.isfinite(out["cuda"][m][0]).all() for m in ("visual", "textual")),
        "preprocess_fills_the_extracted_rows": filled and len(nodes) > 0,
    }
    row = {"phase": "feature_extraction", "items": FX_ITEMS, "images": n_images,
           "reviews": n_reviews, "nodes_filled": len(nodes),
           "visual_max_abs_diff": diff("visual"), "textual_max_abs_diff": diff("textual"),
           "visual_s_per_1000_images": out["cuda"]["visual_s"] / n_images * 1e3,
           "textual_s_per_1000_reviews": out["cuda"]["textual_s"] / n_reviews * 1e3,
           "cpu_visual_s_per_1000_images": out["cpu"]["visual_s"] / n_images * 1e3,
           "cpu_textual_s_per_1000_reviews": out["cpu"]["textual_s"] / n_reviews * 1e3,
           "checks": checks, "ok": all(checks.values())}
    emit(row)
    if not row["ok"]:
        raise RuntimeError(f"feature extraction failed: {checks}")
    return row


# ---- production scale: the memory-aware refresh chunk ------------------------

SCALE_NODES = 100_000  # the scale phase's graph: 100,002 rows, two default chunks
SCALE_FORCED_CHUNK = 16_384  # the chunk under the forced budget: seven chunks
TRANSIENT_TOL = 0.25  # a chunk's measured transient against refresh_transient_bytes


def context_histogram(ids, mask, graph):
    """The contexts' distribution a node, pooled over the real nodes: the
    share of nodes with context size k (0..M) of which j are the node's
    direct neighbours, over the (k, j) cells."""
    import torch

    m = ids.shape[1] - 1
    ctx, valid = ids[2:, 1:], mask[2:, 1:] > 0
    direct = ((ctx[:, :, None] == graph.nbr_ids[2:, None, :]).any(-1) & valid).sum(1)
    cell = valid.sum(1) * (m + 1) + direct
    return torch.bincount(cell, minlength=(m + 1) ** 2).double() / cell.numel()


def run_scale() -> dict:
    """The ``scale`` phase: PMGT pre-training at 100,000 nodes on one card
    through ``tools/scale_smoke`` (TG-layout synthetic data, average
    degree 16, feature widths 1536/768; the default width under the bf16
    policy, batch 512; the ``gather_rows`` dataflow). One refresh (two
    chunks of 65,536), one epoch, valid AUC and export, counted; each
    chunk's measured transient at 8,192 and 65,536 nodes within 25% of
    ``refresh_transient_bytes``; then ``PMGT_TORCH_HBM_BYTES`` set so that
    the budget gives 16,384 (seven chunks): the refresh's peak within the
    budget, its chunk's transient within 25%, and the context distribution
    of the chunked table against the unforced one's (TV < 0.05, the bound
    of tests/test_sampler_parity.py). Then step-1 gradients of the kernel
    route against the plain route under the f32 policy (§2's 1e-4·max|g|
    holds f32 routes)."""
    import gc

    import torch

    from pmgt_tpu_torch.core.device import MEMORY_ENV
    from pmgt_tpu_torch.sampling.pairs import refresh_transient_bytes
    from pmgt_tpu_torch.tasks.pmgt_task import REFRESH_HEADROOM
    from pmgt_tpu_torch.tools import scale_smoke as ss

    t0 = time.perf_counter()
    art = ss.make_dataset(SCALE_NODES)
    gen_s = time.perf_counter() - t0
    (task, build_ms) = timed(lambda: ss.build_task(art, ss.train_args()))
    budget, fusion = dict(task.refresh), task.config.fusion_strategy
    rows = task.sampling.num_total
    transients = [ss.chunk_transient(task, c) for c in (8_192, 65_536)]

    zero_launches()
    epoch = ss.run_epoch(task, 0)
    metrics, eval_ms = timed(lambda: task.evaluate("valid"))
    emb, export_ms = timed(task.export_embeddings)
    launches = read_launches()
    steps, bs = epoch["steps"], task.args.train_batch_size
    chunks_eval = math.ceil(len(task.valid_nodes) / bs)
    chunks_export = math.ceil(art.num_nodes / bs)
    layers = task.config.num_hidden_layers
    want = {"k1": layers * (steps + chunks_eval + chunks_export), "k2": layers * steps,
            "k3": 0, "k4": 0}
    losses = np.asarray(epoch.pop("losses"))
    base_hist = context_histogram(task._train_ctx[0], task._train_ctx[1], task.graph)

    free = 3 * refresh_transient_bytes(task.sampling, SCALE_FORCED_CHUNK)
    os.environ[MEMORY_ENV] = str(REFRESH_HEADROOM + budget["persistent_bytes"]
                                 + budget["cached_bytes"] + free)
    try:
        forced = ss.build_task(art, ss.train_args())
    finally:
        del os.environ[MEMORY_ENV]
    (_, forced_ms), forced_peak = ss.peak_over(
        forced.device, lambda: timed(lambda: forced.on_epoch_start(0)))
    forced_hist = context_histogram(forced._train_ctx[0], forced._train_ctx[1], forced.graph)
    tv = 0.5 * float((base_hist - forced_hist).abs().sum())
    transients.append(ss.chunk_transient(forced, SCALE_FORCED_CHUNK))
    forced_budget = dict(forced.refresh)
    del forced, task
    gc.collect()
    torch.cuda.empty_cache()

    ratio_ok = all(abs(t["measured_over_formula"] - 1) <= TRANSIENT_TOL for t in transients)
    checks = {
        "default_chunk_two_chunks": budget["chunk"] == 65_536 and math.ceil(rows / 65_536) == 2,
        "gather_rows": fusion == "gather_rows",
        "forced_chunk_seven_chunks": (forced_budget["chunk"] == SCALE_FORCED_CHUNK
                                      and math.ceil(rows / SCALE_FORCED_CHUNK) == 7),
        "forced_refresh_peak_within_budget": forced_peak <= forced_budget["free_bytes"],
        "chunk_transients_within_25pct": ratio_ok,
        "context_tv_below_0.05": tv < 0.05,
        "launches_exact": launches == want,
        "losses_finite": bool(np.isfinite(losses).all()),
        "loss_falls": float(losses[-5:].mean()) < float(losses[:5].mean()),
        "export_finite": emb.shape == (art.num_nodes, 128) and bool(np.isfinite(emb).all()),
        "auc_finite": bool(np.isfinite(metrics["val/auc"])),
    }
    row = {"phase": "scale", "num_nodes": art.num_nodes, "rows": rows,
           "max_degree": art.graph.max_degree, "generation_s": gen_s, "task_build_ms": build_ms,
           "fusion": fusion, "refresh_budget": budget,
           "forced_budget": forced_budget, "forced_refresh_ms": forced_ms,
           "forced_refresh_peak_bytes": forced_peak, "chunk_transients": transients,
           "context_tv": tv, "epoch": epoch, "loss_first5": float(losses[:5].mean()),
           "loss_last5": float(losses[-5:].mean()), "evaluate_ms": eval_ms,
           "export_ms": export_ms, **metrics, "launches": launches,
           "expected_launches": want, "eval_chunks": chunks_eval,
           "export_chunks": chunks_export, "checks": checks, "ok": all(checks.values())}
    emit(row)
    if not row["ok"]:
        raise RuntimeError(f"the scale phase failed: {checks}")
    routes = compare_training_routes(
        lambda impl: ss.build_task(art, ss.train_args(mp_enabled=False, attention_impl=impl)),
        "scale_train_route_check")
    gc.collect()
    torch.cuda.empty_cache()
    return {"row": row, "routes": routes, "launches": launches}


def scale_capacity(art, dtype: str, steps: int = 3) -> dict:
    """One refresh and ``steps`` steps of the scale configuration with
    ``dtype`` feature tables on one card: resident and peak memory, the
    refresh and the steps."""
    import gc

    import torch

    from pmgt_tpu_torch.tools import scale_smoke as ss

    gc.collect()
    torch.cuda.empty_cache()
    ss.memory("cuda", reset=True)
    task, build_s = ss.timed_build(art, ss.train_args(feat_tables_dtype=dtype))
    resident = ss.memory("cuda")["allocated_bytes"]
    zero_launches()
    epoch = ss.run_epoch(task, 0, steps)
    out = {"phase": "scale_capacity", "num_nodes": art.num_nodes, "feat_tables_dtype": dtype,
           "task_build_s": build_s, "resident_bytes": resident, **ss.memory("cuda"),
           "card_bytes": torch.cuda.get_device_properties(0).total_memory,
           **ss.table_bytes(task), "refresh_budget": task.refresh,
           "chunks": math.ceil(task.sampling.num_total / task.refresh["chunk"]),
           **epoch, "launches": read_launches()}
    out["ok"] = out["losses_finite"] and out["launches"]["k2"] == 5 * steps
    del task
    gc.collect()
    torch.cuda.empty_cache()
    emit(out)
    return out


def one_card_setup():
    """What a one-card mode does first: the repository on the path, a card
    or None, TF32 off, the card's name and power limit printed (and
    returned), the kernels built."""
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the port's kernels need a GPU", file=sys.stderr)
        return None
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from pmgt_tpu_torch.ops import build

    build.build_all()
    return smi


def scale_main() -> int:
    """``python3 chip_smoke.py --scale``: the scale smoke at 100,000 and
    1,000,000 nodes (a warm-up epoch and 3 measured epochs each), then
    2,500,000 nodes with bf16 and with int8 feature tables (one refresh
    and 3 steps each), all on one card."""
    smi = one_card_setup()
    if smi is None:
        return 1
    import gc

    import torch

    from pmgt_tpu_torch.tools import scale_smoke as ss

    ok = True
    for n in (100_000, 1_000_000):
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        opts = vars(ss.parse(["--num-nodes", str(n)]))
        out = ss.smoke(opts, lambda row, n=n: emit({**row, "scale_nodes": n}))
        steps = sum(len(l) for l in out["losses"])
        launches = read_launches()
        finite = all(np.isfinite(l).all() for l in out["losses"])
        ok &= finite and launches["k2"] == 5 * steps
        emit({"phase": "scale_run", "num_nodes": n, "steps": steps, "launches": launches,
              "peak_allocated_bytes": torch.cuda.max_memory_allocated(), "losses_finite": finite})
        del out
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    art = ss.make_dataset(2_500_000)
    emit({"phase": "scale_capacity_data", "num_nodes": art.num_nodes,
          "max_degree": art.graph.max_degree, "generation_s": time.perf_counter() - t0})
    for dtype in ("bfloat16", "int8"):
        ok &= scale_capacity(art, dtype)["ok"]
    emit({"phase": "scale", "cards": smi, "command_s": time.perf_counter() - T_START, "ok": ok})
    return 0 if ok else 1


def scale_card_rank(num_nodes: int, steps: int, device: str = "cuda") -> dict:
    """In each of the ``--multi-card`` ranks: the scale configuration at
    ``num_nodes`` with both shard flags, one refresh and ``steps`` steps;
    then rank 0 leaves the group and runs the same on its card alone
    with replicated tables."""
    sys.path.insert(0, HERE)
    import gc

    import torch

    from pmgt_tpu_torch.core import mesh
    from pmgt_tpu_torch.tools import scale_smoke as ss

    torch.backends.cuda.matmul.allow_tf32 = False
    m = mesh.current_mesh(device)
    t0 = time.perf_counter()
    art = ss.make_dataset(num_nodes)
    out = {"rank": m.rank, "ranks": m.size, "generation_s": time.perf_counter() - t0}

    def run(args):
        ss.memory(m.device, reset=True)
        task, build_s = ss.timed_build(art, args, m.device)
        row = {"task_build_s": build_s, **ss.table_bytes(task), "refresh_budget": task.refresh,
               "resident_bytes": ss.memory(m.device)["allocated_bytes"],
               **ss.run_epoch(task, 0, steps)}
        del task
        gc.collect()
        return {**row, **ss.memory(m.device)}

    out["sharded"] = run(ss.train_args(shard_feat_tables=True, shard_graph_tables=True,
                                       num_devices=m.size))
    if m.rank == 0:
        mesh.stop()
        if m.device.type == "cuda":
            torch.cuda.empty_cache()
        out["replicated"] = run(ss.train_args())
    return out


def run_multi_card_scale(n_cards: int = 4, num_nodes: int = 2_500_000, steps: int = 3,
                         device: str = "cuda") -> dict:
    """``--multi-card`` at scale: 2,500,000 nodes row-sharded (both flags)
    over ``n_cards`` NCCL ranks, one refresh and 3 steps, against one card
    with replicated tables: each rank's feature tables the total over the
    ranks up to the padding of the block, the chunk the same on every rank
    and the losses within rtol 2e-4 (tests/test_scale_sharded.py's
    tolerance)."""
    import torch

    from pmgt_tpu_torch.core import mesh

    n = min(n_cards, torch.cuda.device_count()) if device == "cuda" else n_cards
    t = time.perf_counter()
    got = mesh.launch(scale_card_rank, n, (num_nodes, steps, device), device=device,
                      timeout_s=900, run_timeout_s=1800)
    launch_s = time.perf_counter() - t
    ref = got[0]["replicated"]
    total = got[0]["sharded"]["feat_total"]
    row_bytes = total / (num_nodes + 2)
    per_rank = [g["sharded"]["feat_rank"] for g in got]
    losses = [np.asarray(g["sharded"]["losses"]) for g in got]
    rel = float(max(np.max(np.abs(l - ref["losses"]) / np.abs(ref["losses"])) for l in losses))
    checks = {
        "rank_bytes_total_over_ranks": all(abs(b - total / n) <= row_bytes for b in per_rank),
        "same_chunk_every_rank": len({g["sharded"]["refresh_budget"]["chunk"] for g in got}) == 1,
        "losses_within_rtol_2e-4": rel <= 2e-4,
        "losses_finite": all(np.isfinite(l).all() for l in losses),
    }
    row = {"phase": "multi_card_scale", "num_nodes": num_nodes, "ranks": n, "steps": steps,
           "launch_s": launch_s, "loss_max_rel_diff": rel,
           "per_rank": [{k: v for k, v in g["sharded"].items() if k != "losses"} | {
               "rank": g["rank"], "generation_s": g["generation_s"],
               "losses": g["sharded"]["losses"]} for g in got],
           "replicated_one_card": ref, "checks": checks, "ok": all(checks.values())}
    emit(row)
    return row


# ---- torch.profiler across sessions ------------------------------------------

PROFILE_SESSIONS = 6


def trace_kernels(profile_dir: str) -> int:
    """Device kernel events in the ``*.pt.trace.json`` files of a profile
    directory."""
    n = 0
    for name in os.listdir(profile_dir) if os.path.isdir(profile_dir) else []:
        if name.endswith(".pt.trace.json"):
            with open(os.path.join(profile_dir, name)) as f:
                n += sum(1 for e in json.load(f).get("traceEvents", [])
                         if e.get("cat") == "kernel")
    return n


def profile_sessions(root: str, n: int = PROFILE_SESSIONS) -> dict:
    """``n`` ``train_model`` calls in this process, each with a
    ``profile_dir`` of its own, one step each at a tiny width (hidden 32,
    1 layer, 300 nodes): the kernel events in each trace, or the error
    of a call whose trace recorded none."""
    sys.path.insert(0, HERE)
    import shutil

    from pmgt_tpu_torch.cli.main import train_model
    from pmgt_tpu_torch.core.config import TrainArgs
    from pmgt_tpu_torch.data.artifacts import save_native
    from pmgt_tpu_torch.data.synthetic import make_synthetic_dataset

    shutil.rmtree(root, ignore_errors=True)
    save_native(os.path.join(root, "syn"), make_synthetic_dataset(
        num_nodes=300, num_users=20, feat_dims=(64, 32), avg_degree=6, seed=0))
    kernels, errors = [], []
    for i in range(n):
        prof = os.path.join(root, f"profile{i}")
        args = TrainArgs(model_name="pmgt", dataset_name="syn", data_dir=root,
                         log_dir=os.path.join(root, "logs"), seed=0, num_epochs=1,
                         train_batch_size=32, test_batch_size=64, valid_size=0.8,
                         profile_dir=prof, extra=dict(hidden_size=32, intermediate_size=32,
                                                      num_hidden_layers=1))
        try:
            train_model("pmgt", args, device="cuda")
            errors.append(None)
        except RuntimeError as e:
            errors.append(str(e))
        kernels.append(trace_kernels(prof))
    return {"kernels": kernels, "errors": errors}


def run_profile_sessions(root: str) -> dict:
    """The ``profile_sessions`` check in a fresh process (so that its
    sessions are the process's first six): every trace holds device
    kernel events."""
    code = ("import json, sys; sys.path.insert(0, '.'); import chip_smoke; "
            f"print(json.dumps(chip_smoke.profile_sessions({root!r})))")
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=HERE, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"the profiler sessions failed: {proc.stderr[-4000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    row = {"phase": "profile_sessions", "sessions": len(out["kernels"]), **out,
           "wall_s": time.perf_counter() - t,
           "ok": all(k > 0 for k in out["kernels"]) and not any(out["errors"])}
    emit(row)
    if not row["ok"]:
        raise RuntimeError(f"a profiled train_model call recorded no device event: {row}")
    return row


# ----------------------------------------------------------------------
# 23. end-to-end quality: tools/validate_pipeline, the int8 tables and the
# reproduction chain (``--quality`` for the full records)
# ----------------------------------------------------------------------
QUALITY_SEEDS = (0, 1, 2)  # downstream seeds of a record, on one export
QUALITY_K1_LANES = (3072, 1536, 512)  # PMGT stage: step, evaluation chunk, export chunk
QUALITY_FAMILIES = "neumf,dcn,gmf,mlp,neumf_pre"  # pmgt_ncf is opt-in


def pmgt_stage_launches(num_nodes: int, epochs: int, valid_size: float = 0.1, batch: int = 256,
                        test_batch: int = 512, layers: int = 5) -> dict:
    """K1/K2 of ``validate_pipeline``'s PMGT stage, from the code: K2 =
    L a step; K1 = L a step, L an evaluation chunk (one evaluation an
    epoch; the stage exports instead of testing) and L an export chunk."""
    from pmgt_tpu_torch.tools.cli_runner import pmgt_run_launches

    return pmgt_run_launches(num_nodes, valid_size, batch, test_batch, layers, epochs, tests=0,
                             export_batch=test_batch)


def metrics_in_range(results: dict) -> dict:
    """Every stage's metrics finite; AUC, N@k and R@k in [0, 1], the BCE
    losses at least 0."""
    bad = {}
    for stage, metrics in results.items():
        if stage in ("provenance", "signal"):
            continue
        for name, v in metrics.items():
            lo, hi = (0.0, math.inf) if name.endswith("loss") else (0.0, 1.0)
            if not (math.isfinite(v) and lo <= v <= hi):
                bad[f"{stage} {name}"] = v
    return bad


def run_quality(root: str) -> dict:
    """The ``quality`` phase: ``tools/validate_pipeline`` at the VG shape
    (7,252 nodes, 27,988 users, signal 0.6) for 1 PMGT epoch and 1 epoch of
    each downstream family but PMGT_NCF, then ``tools/reproduce_published
    --fixture``. Every metric finite and in range, K1/K2 exactly the PMGT
    stage's (the downstream families launch none), the export [7,252, 128]
    and finite, every reproduction stage ``ok``. The comparison with
    ``QUALITY_VG.json`` is printed, not held: 1 + 1 epochs are not the
    record's 8 + 12."""
    from pmgt_tpu_torch.data.synthetic import PUBLISHED_SHAPES
    from pmgt_tpu_torch.tools import reproduce_published as rp
    from pmgt_tpu_torch.tools import validate_pipeline as vp

    out = os.path.join(root, "vg")
    zero_launches()
    (_, vp_ms) = timed(lambda: vp.main(["--shape", "VG", "--pmgt-epochs", "1",
                                        "--downstream-epochs", "1", "--families",
                                        QUALITY_FAMILIES, "--out", out, "--device", "cuda"]))
    launches = read_launches()
    with open(os.path.join(out, "results.json")) as f:
        results = json.load(f)
    n_nodes = PUBLISHED_SHAPES["VG"]["num_nodes"]
    want = pmgt_stage_launches(n_nodes, 1)
    emb = np.load(os.path.join(out, "node_feat_128dim.npy"))
    comparison = vp.compare_to_jax([results], vp.jax_record("VG"), results["pmgt"])

    zero_launches()
    (rp_rc, rp_ms) = timed(lambda: rp.main(["--fixture", "--device", "cuda",
                                            "--work-dir", os.path.join(root, "repro"),
                                            "--report", os.path.join(root, "REPRODUCE_TORCH_fixture.json")]))
    rp_launches = read_launches()
    with open(os.path.join(root, "REPRODUCE_TORCH_fixture.json")) as f:
        report = json.load(f)
    stages = {e["stage"]: e["status"] for e in report["stages"]}
    bad = metrics_in_range(results)
    checks = {
        "every_stage_ran": set(results) >= {"pmgt", "ncf_plain", "ncf_pmgt", "gmf", "mlp",
                                            "neumf_pre", "dcn_plain", "dcn_pmgt"},
        "metrics_finite_in_range": not bad,
        "launches_exact": launches == want,
        "export_shape_finite": emb.shape == (n_nodes, 128) and bool(np.isfinite(emb).all()),
        "reproduce_fixture_ok": rp_rc == 0 and set(stages.values()) == {"ok"},
        "reproduce_kernels_ran": rp_launches["k1"] > 0 and rp_launches["k2"] > 0,
    }
    row = {"phase": "quality", "validate_pipeline_s": vp_ms / 1e3, "results": results,
           "out_of_range": bad, "launches": launches, "expected_launches": want,
           "export_shape": list(emb.shape), "comparison_1_epoch": comparison,
           "reproduce_s": rp_ms / 1e3, "reproduce_stages": stages,
           "reproduce_launches": rp_launches, "checks": checks, "ok": all(checks.values())}
    emit(row)
    if not row["ok"]:
        raise RuntimeError(f"the quality phase failed: {checks}")
    return row


def run_seeds(shape: str, emb_path: str, seeds, root: str,
              families: str = QUALITY_FAMILIES) -> dict:
    """``validate_pipeline --shape <shape> --emb-path <emb_path> --families
    <families>`` for each downstream seed, all at once as processes of
    their own on the one card (``cli_runner.run_processes``); {seed:
    results}."""
    from pmgt_tpu_torch.tools.cli_runner import run_processes

    jobs = {}
    for k in seeds:
        d = os.path.join(root, f"seed{k}")
        os.makedirs(d, exist_ok=True)
        argv = [sys.executable, "-m", "pmgt_tpu_torch.tools.validate_pipeline", "--shape",
                shape, "--emb-path", emb_path, "--downstream-seed", str(k), "--out", d,
                "--families", families, "--device", "cuda"]
        jobs[f"downstream seed {k}"] = (argv, os.path.join(d, "log.txt"))
    wall = run_processes(jobs)
    out = {}
    for k in seeds:
        with open(os.path.join(root, f"seed{k}", "results.json")) as f:
            out[k] = json.load(f)
    # a process is timed when it is reaped, in seed order: the last is all of them
    emit({"phase": "quality_seeds", "shape": shape, "seeds": list(seeds),
          "wall_s": max(wall.values())})
    return out


def val_curves(log_dir: str) -> dict:
    """Per-epoch validation N@20 and R@20 of the one PMGT_NCF run under
    ``log_dir``."""
    from pmgt_tpu_torch.train.registry import RunRegistry

    (run,) = RunRegistry(log_dir).list_runs("pmgt_ncf")
    metrics = run.metrics()
    return {k: [m["value"] for m in metrics if m["name"] == k] for k in ("val/n20", "val/r20")}


def quality_main(argv) -> int:
    """``--quality VG|TG [seed ...]``: PMGT pre-training at seed 0 for 8
    epochs and its export (unless ``outputs/quality_torch_<S>/pretrain``
    already holds them), then the downstream families for 12 epochs at each
    seed (default 0, 1, 2, in parallel processes), gathered with any seed
    already under that directory into ``outputs/QUALITY_TORCH_<S>.json``
    (seeds 0-2) with the comparison against ``QUALITY_<S>.json``; seeds
    other than 0-2, or more, also go into ``..._s<seed>-<seed>....json``,
    compared the same way. ``--quality TG pmgt_ncf [seed ...]``: the same
    with PMGT_NCF as the one family (it trains its own encoder; the
    pre-training gives the record its PMGT row, as the JAX record has one)
    under ``outputs/quality_torch_TG_pmgt_ncf``, into
    ``outputs/QUALITY_TORCH_TG_PMGT_NCF[_s...].json`` against
    ``QUALITY_TG_PMGT_NCF.json``, with each seed's per-epoch validation
    N@20 and R@20. ``--quality int8``:
    ``tools/quality_int8_tables`` at its defaults (10,834 nodes, 8 epochs,
    batch 512) into ``outputs/QUALITY_TORCH_INT8_TG.json``. Exits 0 when
    every run completed; the comparison's verdict is in the record."""
    if one_card_setup() is None:
        return 1
    import torch

    from pmgt_tpu_torch.tools import validate_pipeline as vp

    outputs = os.path.join(HERE, "outputs")
    mode = argv[0]
    if mode == "int8":
        from pmgt_tpu_torch.tools import quality_int8_tables as q8

        art = q8.make_dataset(10834)
        zero_launches()
        variants = [q8.run(art, d, 8, 512, "cuda") for d in ("bfloat16", "int8")]
        record = {"what": "TG-shape (10,834 nodes, 1536+768 feats, paper config) PMGT pretrain: "
                          "int8 vs bfloat16 feature tables, same seed, 8 epochs, one card",
                  "tool": "pmgt_tpu_torch/tools/quality_int8_tables.py --epochs 8",
                  "provenance": vp.provenance(sys.argv[1:]), "variants": variants,
                  "verdict": q8.verdict(*variants), "launches": read_launches(),
                  "jax_record": "QUALITY_INT8_TG.json"}
        records = {"QUALITY_TORCH_INT8_TG.json": record}
    else:
        pmgt_ncf = argv[1:2] == ["pmgt_ncf"]
        rest = argv[2:] if pmgt_ncf else argv[1:]
        shape, seeds = mode, tuple(int(a) for a in rest) or QUALITY_SEEDS
        suffix = "_pmgt_ncf" if pmgt_ncf else ""
        root = os.path.join(outputs, f"quality_torch_{shape}{suffix}")
        pre = os.path.join(root, "pretrain")
        emb_path = os.path.join(pre, "node_feat_128dim.npy")
        if not (os.path.exists(emb_path) and os.path.exists(os.path.join(pre, "results.json"))):
            zero_launches()
            (_, ms) = timed(lambda: vp.main(["--shape", shape, "--families", "", "--out", pre,
                                             "--device", "cuda"]))
            emit({"phase": "quality_pretrain", "shape": shape, "s": ms / 1e3,
                  "launches": read_launches()})
        with open(os.path.join(pre, "results.json")) as f:
            pmgt = json.load(f)["pmgt"]
        run_seeds(shape, emb_path, seeds, root,
                  families="pmgt_ncf" if pmgt_ncf else QUALITY_FAMILIES)
        done = {}
        for name in sorted(os.listdir(root)):
            path = os.path.join(root, name, "results.json")
            if name.startswith("seed") and os.path.exists(path):
                with open(path) as f:
                    done[int(name[4:])] = json.load(f)
        jax_name = f"QUALITY_{shape}{suffix.upper()}.json"
        prov = vp.provenance(sys.argv[1:])
        # the record of seeds 0-2; other seeds, or more, in a record of their own
        groups = [sorted(done)]
        groups += [list(QUALITY_SEEDS)] if set(QUALITY_SEEDS) < set(done) else []
        records = {}
        for group in groups:
            record = vp.quality_record(shape, {k: done[k] for k in group}, prov, pmgt,
                                       jax_name=jax_name)
            if pmgt_ncf:
                record["val_curves"] = {str(k): val_curves(os.path.join(root, f"seed{k}", "logs"))
                                        for k in group}
            tag = "" if group == list(QUALITY_SEEDS) else "_s" + "-".join(map(str, group))
            records[f"QUALITY_TORCH_{shape}{suffix.upper()}{tag}.json"] = record
    for name, record in records.items():
        record["command_s"] = time.perf_counter() - T_START
        with open(os.path.join(outputs, name), "w") as f:
            json.dump(record, f, indent=1)
        emit({"phase": "quality_record", "file": f"outputs/{name}",
              "verdict": record.get("verdict") or record["comparison"]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


# ----------------------------------------------------------------------
# 24. the evidence tools: dcn_sensitivity, neumf_pre_bisect, hpo_tg_study
# and hpo_pmgt_study (``--evidence`` for the full records)
# ----------------------------------------------------------------------
EVIDENCE_DATA = dict(num_nodes=2000, num_users=1500)  # the HPO studies' small TG layout
EVIDENCE = {  # mode: (tool, record, JAX record)
    "dcn": ("dcn_sensitivity", "DCN_SENSITIVITY_TORCH_TG.json", "DCN_SENSITIVITY_TG.json"),
    "dcn-frozen": ("dcn_sensitivity", "DCN_SENSITIVITY_TORCH_TG_FROZEN.json",
                   "DCN_SENSITIVITY_TG_FROZEN.json"),
    "neumf-pre": ("neumf_pre_bisect", "QUALITY_TORCH_NEUMF_PRE_BISECT_TG.json",
                  "QUALITY_NEUMF_PRE_BISECT_TG.json"),
    "hpo-mlp": ("hpo_tg_study", "HPO_TORCH_TG_MLP_PMGT.json", "HPO_TG_MLP_PMGT.json"),
    "hpo-pmgt": ("hpo_pmgt_study", "HPO_TORCH_TG_PMGT.json", "HPO_TG_PMGT.json"),
}
NCF_KEYS = {"lr", "test/loss", "test/n10", "test/r10", "test/n20", "test/r20"}


def numbers_finite(obj) -> bool:
    """Every number in ``obj`` (nested dicts and lists) finite."""
    if isinstance(obj, dict):
        return all(numbers_finite(v) for v in obj.values())
    if isinstance(obj, list):
        return all(numbers_finite(v) for v in obj)
    return not isinstance(obj, float) or math.isfinite(obj)


def jax_record(mode: str) -> dict:
    with open(os.path.join(HERE, EVIDENCE[mode][2])) as f:
        return json.load(f)


def jax_keys(mode: str, report: dict) -> bool:
    """``report`` has the keys the JAX tool writes, with finite numbers."""
    if mode == "neumf-pre":  # the tool's dict: an entry an arm
        have = report["full"]
        ok = ({"gmf", "mlp", "neumf_pre_init_only"} <= set(have)
              and all(set(v) == NCF_KEYS for v in have.values()))
    else:  # less what was added to the JAX record by hand
        ok = set(jax_record(mode)) - {"pruning_note"} <= set(report)
    return ok and numbers_finite(report)


def restore_ok(report: dict) -> bool:
    """A study's best checkpoint, restored in the tool's process, equal to
    its trial's logged results within 1e-5."""
    from pmgt_tpu_torch.tools.cli_runner import restore_check

    logged = report["trial_records"][str(report["best"]["number"])]["results"]
    return restore_check(logged, report["restore_in_process"]["results"])["ok"]


def hpo_launch_checks(tg: dict, pm: dict) -> dict:
    """The PMGT stages of both studies: each process's K1–K4 exactly as
    the code predicts (hpo_tg_study's pre-training and export at d = 32,
    64, 128; each PMGT trial at its d and β; the restore)."""
    stages = [s for s in tg["stages"] if s["stage"].startswith("pretrain_h")]
    trials = list(pm["trial_records"].values())
    return {
        "pretrain_stages_exact": len(stages) == 3
        and all(s["launches"] == s["expected_launches"] for s in stages),
        "pmgt_trials_exact": bool(trials)
        and all(r["launches"] == r["expected_launches"] for r in trials),
        "pmgt_restore_exact": pm["restore_in_process"]["launches"]
        == pm["restore_expected_launches"],
        "kernels_ran": all(s["launches"]["train"]["k2"] > 0 for s in stages)
        and all(r["launches"]["k1"] > 0 and r["launches"]["k2"] > 0 for r in trials),
    }


def hpo_launches(tg: dict, pm: dict) -> dict:
    """K1/K2 the two studies' processes launched, summed."""
    rows = [s["launches"][k] for s in tg["stages"] if s["stage"].startswith("pretrain_h")
            for k in ("train", "export")]
    rows += [r["launches"] for r in pm["trial_records"].values()]
    rows.append(pm["restore_in_process"]["launches"])
    return {k: sum(r[k] for r in rows) for k in ("k1", "k2")}


def write_small_tg(path: str) -> None:
    """A small dataset of TG's layout (feature widths 1536/768) at ``path``."""
    from pmgt_tpu_torch.data.artifacts import save_native
    from pmgt_tpu_torch.data.synthetic import make_synthetic_dataset

    save_native(path, make_synthetic_dataset(**EVIDENCE_DATA, seed=42))


def run_evidence(root: str, vg_emb: str) -> dict:
    """The ``evidence`` phase, each tool at a cut: ``dcn_sensitivity`` on
    the ``quality`` phase's VG export (1 seed, 1 epoch) without and with
    ``--freeze``; ``neumf_pre_bisect`` at its small default size (2 epochs,
    ladder 1e-3, 1e-4:2); each HPO study with one trial of one epoch and one
    ``hp-tuning`` round on a small TG-layout dataset (``EVIDENCE_DATA``)
    written first. The five run at once, each in a thread (host bound, and
    mostly waiting on processes of their own); only the PMGT study's
    restore launches kernels in this process.
    Checks: every report has the JAX tool's keys with finite numbers; the
    frozen ``zero`` arm's AUC exactly 0.5; each restored best checkpoint
    equal to its trial's logged results within 1e-5; the PMGT stages' and
    trials' K1/K2 exact. The comparisons with the JAX records are printed,
    not held: a cut is not the records' protocol."""
    import importlib
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    tools = {m: importlib.import_module(f"pmgt_tpu_torch.tools.{EVIDENCE[m][0]}")
             for m in EVIDENCE}
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    seconds = {}

    def study(mode, *argv):
        work = os.path.join(root, mode)
        write_small_tg(os.path.join(work, "data", "TG"))
        tool = tools[mode]
        return tool.run(tool.parse(["--work", work, "--out", work + ".json", "--n-trials", "1",
                                    "--trial-epochs", "1", "--device", "cuda", *argv]),
                        rounds=1)

    def report(mode, *argv):
        out = os.path.join(root, mode)
        tools[mode].main(["--out", out, "--report", out + ".json", "--device", "cuda", *argv])
        with open(out + ".json") as f:
            return json.load(f)

    def timed_job(mode, fn, *argv):
        t = time.perf_counter()
        result = fn(mode, *argv)
        seconds[mode] = time.perf_counter() - t
        return result

    dcn = ("--shape", "VG", "--emb-path", vg_emb, "--seeds", "0", "--downstream-epochs", "1")
    jobs = {"hpo-mlp": (study, "--pretrain-epochs", "1"), "hpo-pmgt": (study,),
            "dcn": (report, *dcn), "dcn-frozen": (report, *dcn, "--freeze"),
            "neumf-pre": (report, "--epochs", "2", "--lrs", "1e-3,1e-4:2")}
    zero_launches()
    with ThreadPoolExecutor(len(jobs)) as pool:  # every tool at once; each raises here
        futures = {mode: pool.submit(timed_job, mode, *job) for mode, job in jobs.items()}
        reports = {mode: f.result() for mode, f in futures.items()}
    in_process = read_launches()
    tg, pm = reports["hpo-mlp"], reports["hpo-pmgt"]
    zero = [v for k, v in reports["dcn-frozen"]["auc_exact"].items() if k.startswith("zero_s")]
    restored = {mode: restore_ok(reports[mode]) for mode in ("hpo-mlp", "hpo-pmgt")}
    checks = {
        **{f"{mode}_jax_keys_finite": jax_keys(mode, reports[mode]) for mode in EVIDENCE},
        "frozen_zero_auc_is_0.5": zero == [0.5],
        **{f"{mode}_restore_within_1e-5": ok for mode, ok in restored.items()},
        **hpo_launch_checks(tg, pm),
        "in_process_launches_are_the_restore": in_process
        == pm["restore_in_process"]["launches"],
    }
    comparisons = {mode: tools[mode].compare_to_jax(reports[mode], jax_record(mode))
                   for mode in EVIDENCE}
    row = {"phase": "evidence", "s": time.perf_counter() - t0, "tool_s": seconds,
           "launches": hpo_launches(tg, pm),
           "pmgt_trials": {k: {x: r[x] for x in ("hidden_size", "beta", "num_hidden_layers",
                                                 "epochs", "launches")}
                           for k, r in pm["trial_records"].items()},
           "comparison_cut_misses": {k: v["misses"] for k, v in comparisons.items()},
           "checks": checks, "ok": all(checks.values())}
    emit(row)
    if not row["ok"]:
        raise RuntimeError(f"the evidence phase failed: {checks}")
    return row


def evidence_main(mode: str) -> int:
    """``--evidence <mode>``: one tool at its published protocol on one
    card, its report held against the JAX record (``EVIDENCE``) and written
    to ``outputs/<record>``: ``dcn`` / ``dcn-frozen`` (TG, PMGT 8 epochs,
    seeds 0–2 of 12 epochs side by side), ``neumf-pre`` (TG, 12 epochs,
    ladder 1e-3, 1e-4, 1e-4:36), ``hpo-mlp`` and ``hpo-pmgt`` (TG, the JAX
    tools' defaults). Exits 0 when the tool ran to its end; the verdict is
    in the record."""
    if one_card_setup() is None:
        return 1
    import importlib

    import torch

    name, record_name, jax_name = EVIDENCE[mode]
    tool = importlib.import_module(f"pmgt_tpu_torch.tools.{name}")
    outputs = os.path.join(HERE, "outputs")
    work = os.path.join(outputs, f"evidence_{mode}")
    argv = {"dcn": ["--shape", "TG"], "dcn-frozen": ["--shape", "TG", "--freeze"],
            "neumf-pre": ["--shape", "TG", "--lrs", "1e-3,1e-4,1e-4:36"],
            "hpo-mlp": [], "hpo-pmgt": []}[mode]
    if name in ("dcn_sensitivity", "neumf_pre_bisect"):
        argv += ["--out", work, "--report", work + ".json", "--device", "cuda"]
        tool.main(argv)
        with open(work + ".json") as f:
            report = json.load(f)
    else:
        report = tool.run(tool.parse([*argv, "--work", work, "--out", work + ".json",
                                      "--device", "cuda"]))
    report["comparison"] = tool.compare_to_jax(report, jax_record(mode))
    report.update(jax_record=jax_name, command_s=time.perf_counter() - T_START)
    with open(os.path.join(outputs, record_name), "w") as f:
        json.dump(report, f, indent=1)
    emit({"phase": "evidence_record", "file": f"outputs/{record_name}",
          "comparison": report["comparison"]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


DCN_FROZEN_SEEDS = (0, 3, 4, 5, 6, 7, 8)  # seed 0 again: does the card reproduce the record?
DCN_BF16_SEEDS = tuple(range(9))  # the frozen real arm under the TPU's DEFAULT precision


def frozen_real_export(work: str):
    """The record's export: ``--evidence dcn-frozen``'s PMGT stage (seed 0)
    in ``work``, and its ``real`` variant at ``work/emb_real.npy``;
    (tool namespace, artifacts, signal, PMGT results, the export's sha256)."""
    import hashlib

    from pmgt_tpu_torch.tasks import pmgt_task
    from pmgt_tpu_torch.tools import dcn_sensitivity as ds
    from pmgt_tpu_torch.tools import validate_pipeline as vp
    from pmgt_tpu_torch.train.registry import RunRegistry

    ns = ds.parse(["--shape", "TG", "--freeze", "--out", work, "--device", "cuda"])
    art, signal = ds.make_dataset(ns)
    emb = os.path.join(work, "node_feat_128dim.npy")
    pmgt, _ = vp.run_task(pmgt_task, ds.pmgt_args(ns), art, RunRegistry(os.path.join(work, "logs")),
                          "PMGT", "cuda", export_path=emb)
    np.save(os.path.join(work, "emb_real.npy"), ds.variants(np.load(emb))["real"])
    with open(emb, "rb") as f:
        sha = hashlib.sha256(f.read()).hexdigest()
    return ns, art, signal, pmgt, sha


def dcn_frozen_seeds(work: str, seeds) -> dict:
    """The frozen ``real`` arm of ``--evidence dcn-frozen`` at more
    downstream seeds on the record's export (PMGT seed 0), one after the
    other in this process, pooled with the record's seeds 0-2
    (``DCN_SENSITIVITY_TORCH_TG_FROZEN.json``) and set beside the JAX
    record's own spread: the gap of the means against their combined
    standard error, sqrt(σ_port²/n_port + σ_jax²/n_jax). The record's
    bound is not changed by this."""
    from pmgt_tpu_torch.tasks import dcn_task
    from pmgt_tpu_torch.tools import dcn_sensitivity as ds
    from pmgt_tpu_torch.tools import validate_pipeline as vp
    from pmgt_tpu_torch.train.registry import RunRegistry

    ns, art, signal, pmgt, _ = frozen_real_export(work)
    log_dir = os.path.join(work, "logs")
    registry = RunRegistry(log_dir)
    auc = {}
    for k in seeds:
        args = ds.dcn_args(ns, k, os.path.join(work, "emb_real.npy"), log_dir)
        res, _ = vp.run_task(dcn_task, args, art, registry, f"dcn_real_s{k}", "cuda")
        auc[k] = res["test/auc"]
        emit({"phase": "bisect_dcn_frozen_seed", "seed": k, "real_frozen_test_auc": auc[k]})
    rec, jax = dcn_frozen_records()
    return {"what": "frozen real arm of the DCN sensitivity at more downstream seeds on the "
                    "record's export (PMGT seed 0), pooled with the record's seeds 0-2",
            "signal": signal, "pmgt": pmgt,
            "real_frozen_test_auc": {str(k): v for k, v in auc.items()},
            **seed_gap(auc, rec, jax)}


def dcn_frozen_records():
    """(the port's frozen record's ``auc_exact``, the JAX record's ``auc``)."""
    with open(os.path.join(HERE, "DCN_SENSITIVITY_TORCH_TG_FROZEN.json")) as f:
        rec = json.load(f)["auc_exact"]
    with open(os.path.join(HERE, "DCN_SENSITIVITY_TG_FROZEN.json")) as f:
        return rec, json.load(f)["auc"]


def dcn_seed_worker(work: str, seed: int, emulate: bool) -> None:
    """One frozen ``real`` arm run on the card in this process, on the
    dataset and export ``dcn_frozen_bf16`` wrote under ``work``; with
    ``emulate`` inside ``tpu_default_precision``. Writes its AUC, the
    count of rounded products and its seconds to
    ``work/<bf16|f32>_s<seed>.json``."""
    sys.path.insert(0, HERE)
    import logging

    import torch

    from pmgt_tpu_torch.data.artifacts import load_artifacts
    from pmgt_tpu_torch.tasks import dcn_task
    from pmgt_tpu_torch.tools import dcn_sensitivity as ds
    from pmgt_tpu_torch.tools import validate_pipeline as vp
    from pmgt_tpu_torch.tools.tpu_precision import tpu_default_precision
    from pmgt_tpu_torch.train.registry import RunRegistry

    logging.basicConfig(level=logging.INFO)  # each epoch's line in the run's log
    torch.backends.cuda.matmul.allow_tf32 = False
    ns = ds.parse(["--shape", "TG", "--freeze", "--out", work, "--device", "cuda"])
    art = load_artifacts(os.path.join(work, "data"), ds.DATASET)
    tag = f"{'bf16' if emulate else 'f32'}_s{seed}"
    log_dir = os.path.join(work, tag)
    args = ds.dcn_args(ns, seed, os.path.join(work, "emb_real.npy"), log_dir)
    t0 = time.perf_counter()
    if emulate:
        with tpu_default_precision() as mode:
            res, _ = vp.run_task(dcn_task, args, art, RunRegistry(log_dir), tag, "cuda")
        calls = mode.calls
    else:
        res, _ = vp.run_task(dcn_task, args, art, RunRegistry(log_dir), tag, "cuda")
        calls = 0
    with open(os.path.join(work, tag + ".json"), "w") as f:
        json.dump({"test_auc": res["test/auc"], "rounded_products": calls,
                   "s": time.perf_counter() - t0}, f)


def dcn_frozen_bf16(work: str, seeds) -> dict:
    """The frozen ``real`` arm of ``--evidence dcn-frozen`` on the record's
    export with every matmul of the DCN as a TPU runs an f32 dot at XLA's
    DEFAULT precision (``tools/tpu_precision``: bf16 operands, f32
    accumulation, forward and both backward products), at ``seeds``, and
    seed 0 again in f32 as the control that the export is the record's.
    Each run is a process of its own, all at once (host bound). The bf16
    seeds alone (not pooled with the f32 record) against the JAX record,
    taken on a TPU v5e: ``seed_gap`` and the tool's bound max(3σ, 0.005)."""
    from pmgt_tpu_torch.data.artifacts import save_native
    from pmgt_tpu_torch.tools import dcn_sensitivity as ds
    from pmgt_tpu_torch.tools import validate_pipeline as vp
    from pmgt_tpu_torch.tools.cli_runner import run_processes

    _, art, signal, pmgt, sha = frozen_real_export(work)
    save_native(os.path.join(work, "data", ds.DATASET), art)
    runs = [(True, k) for k in seeds] + [(False, 0)]
    jobs = {}
    for emulate, k in runs:
        code = (f"import sys; sys.path.insert(0, {HERE!r}); import chip_smoke; "
                f"chip_smoke.dcn_seed_worker({work!r}, {k}, {emulate})")
        tag = f"{'bf16' if emulate else 'f32'}_s{k}"
        jobs[tag] = ([sys.executable, "-c", code], os.path.join(work, tag + ".log"))
    seconds = run_processes(jobs)
    rows = {}
    for tag in jobs:
        with open(os.path.join(work, tag + ".json")) as f:
            rows[tag] = json.load(f)
        emit({"phase": "bisect_dcn_frozen_bf16_run", "run": tag, **rows[tag]})
    bf16 = {k: rows[f"bf16_s{k}"]["test_auc"] for k in seeds}
    rec, jax = dcn_frozen_records()
    gap = seed_gap(bf16, {}, jax)
    bound = max(ds.SIGMAS * gap["pooled_port"]["std"], ds.AUC_FLOOR)
    control = rows["f32_s0"]["test_auc"]
    return {"what": "frozen real arm of the DCN sensitivity on the record's export (PMGT seed "
                    "0) with every DCN matmul at the TPU's DEFAULT precision (bf16 operands, "
                    "f32 accumulation, forward and both backward products), against the JAX "
                    "record taken on a TPU v5e",
            "signal": signal, "pmgt": pmgt, "export_sha256": sha,
            "bf16_real_frozen_test_auc": {str(k): v for k, v in bf16.items()},
            "rounded_products": {tag: r["rounded_products"] for tag, r in rows.items()},
            "f32_control_s0": {"test_auc": control, "record": rec["real_s0"],
                               "minus_record": control - rec["real_s0"]},
            "run_s": seconds, **gap, "bound": bound,
            "bound_rule": "max(3 * sample sigma of the bf16 seeds, 0.005), the tool's own",
            "within_bound_of_jax": abs(gap["gap"]) <= bound}


def seed_gap(auc: dict, record: dict, jax: dict) -> dict:
    """The ``real`` arm's AUC at seeds ``auc`` ({seed: AUC}) pooled with a
    record's (``auc_exact``: the record's value where both have a seed)
    against the JAX record's seeds (``auc``): each side's mean and sample
    σ, how far each new seed that the record has reproduces it, the gap
    of the means and its combined standard error."""
    from pmgt_tpu_torch.tools import validate_pipeline as vp

    rec = {int(k[6:]): v for k, v in record.items() if k.startswith("real_s")}
    pooled = {**auc, **rec}
    port = vp.mean_std(list(pooled.values()))
    ref = vp.mean_std([v for k, v in jax.items() if k.startswith("real_s")])
    se = math.sqrt(port["std"] ** 2 / port["n"] + ref["std"] ** 2 / ref["n"])
    gap = port["mean"] - ref["mean"]
    return {"record_seeds": {str(k): v for k, v in rec.items()},
            "reproduced": {str(k): auc[k] - rec[k] for k in auc if k in rec},
            "pooled_port": port, "jax": ref, "gap": gap, "combined_se": se,
            "gap_over_se": gap / se}


def bisect_main(what: str, seed: int = 0, seeds=DCN_FROZEN_SEEDS) -> int:
    """``--bisect dcn-frozen-seeds [seed ...]``: ``dcn_frozen_seeds`` at
    ``seeds`` (default ``DCN_FROZEN_SEEDS``), into
    ``outputs/BISECT_TORCH_DCN_FROZEN_SEEDS.json``. ``--bisect
    dcn-frozen``: the frozen ``real`` arm of ``--evidence
    dcn-frozen`` (downstream seed 0) on the exports of three pre-trainings,
    seeds 0, 1, 2 (the tool's PMGT stage with its seed changed): how far the
    arm moves with the export, which the record's σ over downstream seeds on
    one export does not see. ``--bisect neumf-pre <seed>``: ``--evidence
    neumf-pre`` (ladder 1e-3, 1e-4) with every run at downstream seed
    ``seed``: how far the fine-tuned arms move with the seed, which a record
    of one run per arm does not see. ``--bisect dcn-frozen-bf16 [seed
    ...]``: ``dcn_frozen_bf16`` at ``seeds`` (default ``DCN_BF16_SEEDS``),
    into ``outputs/BISECT_TORCH_DCN_FROZEN_BF16.json``. Each writes
    ``outputs/BISECT_TORCH_<what>[_s<seed>].json``."""
    if one_card_setup() is None:
        return 1
    import dataclasses

    import torch

    from pmgt_tpu_torch.tools import validate_pipeline as vp
    from pmgt_tpu_torch.train.registry import RunRegistry

    outputs = os.path.join(HERE, "outputs")
    work = os.path.join(outputs, f"bisect_{what}_s{seed}")
    if what == "dcn-frozen-seeds":
        record = dcn_frozen_seeds(work, seeds)
        name = "BISECT_TORCH_DCN_FROZEN_SEEDS.json"
    elif what == "dcn-frozen-bf16":
        record = dcn_frozen_bf16(work, seeds)
        name = "BISECT_TORCH_DCN_FROZEN_BF16.json"
    elif what == "dcn-frozen":
        from pmgt_tpu_torch.tasks import dcn_task, pmgt_task
        from pmgt_tpu_torch.tools import dcn_sensitivity as ds

        ns = ds.parse(["--shape", "TG", "--freeze", "--out", work, "--device", "cuda"])
        art, signal = ds.make_dataset(ns)
        registry = RunRegistry(os.path.join(work, "logs"))
        rows = {}
        for pre_seed in (0, 1, 2):
            emb = os.path.join(work, f"node_feat_128dim_s{pre_seed}.npy")
            pmgt, _ = vp.run_task(pmgt_task, dataclasses.replace(ds.pmgt_args(ns), seed=pre_seed),
                                  art, registry, f"PMGT_s{pre_seed}", "cuda", export_path=emb)
            real, _ = vp.run_task(dcn_task, ds.dcn_args(ns, 0, emb, os.path.join(work, "logs")),
                                  art, registry, f"dcn_real_pre{pre_seed}_s0", "cuda")
            rows[str(pre_seed)] = {"pmgt": pmgt, "real_frozen_test_auc_s0": real["test/auc"]}
            emit({"phase": "bisect_dcn_frozen", "pretrain_seed": pre_seed, **rows[str(pre_seed)]})
        record = {"what": "frozen real arm of the DCN sensitivity (downstream seed 0) on the "
                          "exports of PMGT pre-training seeds 0, 1, 2", "signal": signal,
                  "by_pretrain_seed": rows,
                  "spread": vp.mean_std([r["real_frozen_test_auc_s0"] for r in rows.values()])}
        name = "BISECT_TORCH_DCN_FROZEN.json"
    else:
        from pmgt_tpu_torch.tools import neumf_pre_bisect as nb

        ns = nb.parse(["--shape", "TG", "--lrs", "1e-3,1e-4", "--out", work, "--device", "cuda"])
        art, signal = nb.make_dataset(ns)
        tool_args = nb.ncf_args
        nb.ncf_args = lambda *a: dataclasses.replace(tool_args(*a), seed=seed)
        try:
            record = nb.run(ns, art, signal)
        finally:
            nb.ncf_args = tool_args
        record["seed"] = seed
        name = f"BISECT_TORCH_NEUMF_PRE_s{seed}.json"
    record.update(provenance=vp.provenance(sys.argv[1:]), command_s=time.perf_counter() - T_START)
    with open(os.path.join(outputs, name), "w") as f:
        json.dump(record, f, indent=1)
    emit({"phase": "bisect_record", "file": f"outputs/{name}"})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


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
    clock("build")

    # ---- 2. K1 against its plain version --------------------------------
    checks = [
        check_k1(6, n, 128, dt, km)
        for n in (768, 256)
        for dt in (torch.float32, torch.bfloat16)
        for km in (False, True)
    ]
    # K1 at the training lanes (256 targets + 2,560 pairs + 256 masked)
    checks += [check_k1(6, 3072, 128, torch.float32, km) for km in (False, True)]
    # K1 at PMGT_NCF's lanes: an evaluation chunk (4 users x 1,000
    # candidates) and the largest call of the serving item stage (64 users
    # x 1,024 items), no dropout
    checks += [check_k1(6, n, 128, torch.float32, False) for n in (4000, 65536)]
    # bf16 at the published configurations: PMGT (d = 32, 384 training
    # lanes: 32 targets + 320 pairs + 32 masked) and PMGT_NCF (an evaluation
    # chunk and the largest serving item-stage call)
    checks += [check_k1(6, 384, 32, torch.bfloat16, km) for km in (False, True)]
    checks += [check_k1(6, n, 128, torch.bfloat16, False) for n in (4000, 65536)]
    # bf16 at the PMGT search space's shapes (hp-tuning: batch 32, P = 10):
    # d = 64, and d = 32 with β = 0 (no cosine branch), 0.25 and 1
    tuning = [(64, 0.5), (32, 0.0), (32, 0.25), (32, 1.0)]
    checks += [check_k1(6, 384, d, torch.bfloat16, True, beta) for d, beta in tuning]
    # bf16 at the quality tools' PMGT stage (batch 256, test batch 512):
    # training, evaluation and export lanes
    checks += [check_k1(6, n, 128, torch.bfloat16, km) for n in QUALITY_K1_LANES
               for km in (False, True)]
    results["k1_checks"] = checks

    # ---- 5. K2 against its plain version (N=256: PMGT_NCF's training step)
    k2_checks = [check_k2(6, n, 128, km) for n in (3072, 768, 256, 37)
                 for km in (False, True)]
    # bf16 at the published training steps: PMGT (d = 32, 384 lanes) and
    # PMGT_NCF (d = 128, 128 lanes), dropout on
    k2_bf16 = [check_k2(6, 384, 32, km, torch.bfloat16) for km in (False, True)]
    k2_bf16.append(check_k2(6, 128, 128, True, torch.bfloat16))
    k2_bf16 += [check_k2(6, 384, d, True, torch.bfloat16, beta) for d, beta in tuning]
    k2_bf16.append(check_k2(6, 3072, 128, True, torch.bfloat16))  # the quality tools' step
    results["k2_checks"] = k2_checks + k2_bf16

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
    clock("kernel_checks")

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
    clock("serving")
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
    clock("training")
    cli = run_cli(art, os.path.join(HERE, "outputs", "chip_smoke_cli"), smi)
    clock("cli")

    # ---- 10b. train-pmgt with scripts/run_pmgt.sh's arguments (bf16) ------
    cli_data = os.path.join(HERE, "outputs", "chip_smoke_cli", "data")  # phase 10's data
    published = run_published_pmgt(cli_data, os.path.join(HERE, "outputs",
                                                           "chip_smoke_published"))

    # ---- 11-15. the downstream recommenders --------------------------------
    emb_path = os.path.join(HERE, "outputs", "chip_smoke_cli", "emb.npy")  # phase 10's export
    clock("published_pmgt")
    ncf = run_ncf(art, emb_path)
    art_cut = cut_users(art, PMGT_NCF_USERS)
    pncf = run_pmgt_ncf(art_cut)
    dcn = run_dcn(art_cut, emb_path)
    down_root = os.path.join(HERE, "outputs", "chip_smoke_downstream")
    clock("ncf_pmgt_ncf_dcn")
    down_cli = run_downstream_cli(art_cut, down_root, emb_path, published["emb_path"])
    clock("downstream_cli")
    # ---- 15b. train-pmgt-ncf with scripts/run_pmgt_ncf.sh's arguments (bf16)
    pub_ncf = run_published_pmgt_ncf(art_cut, os.path.join(down_root, "data"),
                                     os.path.join(HERE, "outputs", "chip_smoke_published_ncf"))
    # where the time goes: one profiled pass of each downstream path and of
    # the published bf16 paths, in one profiler session (not counted)
    down_busy = profile_phases(ncf["profiled"] + pncf["profiled"] + published["profiled"]
                               + pub_ncf["profiled"])
    emit({"phase": "downstream_profile",
          "profiled": down_busy or "not measured: the profiler saw no device kernel"})

    # ---- 16. the remaining options of train-pmgt (--profile-dir opens the
    # last profiler session, so it comes after the profiled passes)
    options = run_options(cli_data, os.path.join(HERE, "outputs", "chip_smoke_options"))
    clock("options")
    # six profiled train_model calls in a fresh process: a trace each
    prof_sessions = run_profile_sessions(os.path.join(HERE, "outputs",
                                                      "chip_smoke_profile_sessions"))
    clock("profile_sessions")

    # ---- 17-19. the data and tuning commands: preprocess a review dump,
    # then hp-tuning on it (PMGT trials on K1/K2; the NeuMF-PMGT search)
    pre = run_preprocess(os.path.join(HERE, "outputs", "chip_smoke_preprocess"), DUMP)
    clock("preprocess")
    hpo_pmgt = run_hpo_pmgt(pre["data_dir"], os.path.join(HERE, "outputs", "chip_smoke_hpo_pmgt"),
                            pre["art"])
    clock("hpo_pmgt")
    hpo_ncf = run_hpo_ncf(pre["data_dir"], os.path.join(HERE, "outputs", "chip_smoke_hpo_ncf"),
                          pre["art"])
    clock("hpo_ncf")

    # ---- 20. the feature extractors on the card (stand-in models)
    fx_row = run_feature_extraction(os.path.join(HERE, "outputs", "chip_smoke_features"))
    clock("feature_extraction")

    # ---- 22. production scale: 100,000 nodes, the budgeted refresh chunk
    scale = run_scale()
    clock("scale")

    # ---- 23. end-to-end quality: validate_pipeline at the VG shape (1 + 1
    # epochs) and the reproduction chain on the fixture
    quality = run_quality(os.path.join(HERE, "outputs", "chip_smoke_quality"))
    clock("quality")

    # ---- 24. the evidence tools at a cut: DCN sensitivity on the quality
    # phase's VG export, the NeuMF-pre bisect, and both HPO studies
    evidence = run_evidence(os.path.join(HERE, "outputs", "chip_smoke_evidence"),
                            os.path.join(HERE, "outputs", "chip_smoke_quality", "vg",
                                         "node_feat_128dim.npy"))
    clock("evidence")

    # ---- 21. data parallelism: one NCCL rank; two gloo ranks sharing the
    # card (train-pmgt replicated and sharded, NCF, DCN, PMGT_NCF, then
    # hp-tuning studies on phase 17's data)
    studies = multi_rank_studies(pre["data_dir"], pre["art"], hpo_ncf["space_path"],
                                 hpo_ncf["cfg"],
                                 os.path.join(HERE, "outputs", "chip_smoke_multi_rank_studies"))
    multi = run_multi_rank(cli_data, os.path.join(down_root, "data"),
                           os.path.join(HERE, "outputs", "chip_smoke_multi_rank"), studies)
    clock("multi_rank")

    # ---- summary ---------------------------------------------------------
    # Each kernel at its main path's shape (K1/K2 the training lanes, K3/K4
    # the public op at 3,072 lanes) with keep masks (dropout on); launches
    # over every counted run, by path.
    def pick(rows, n):
        return next(r for r in rows if r.get("N", r.get("B*h")) == n and r["keep_masks"]
                    and r["dtype"] == "float32" and r.get("h", 1) == 1)

    def summed(invocations, keep=lambda name: True):
        return {k: sum(v["launches"][k] for n, v in invocations.items() if keep(n))
                for k in ("k1", "k2")}

    cli_launches = summed(cli["invocations"])
    pncf_launches = pncf["row"]["launches"]
    pncf_cli = summed(down_cli["invocations"], lambda n: n.startswith("train-pmgt-ncf"))
    pub = published["row"]["invocations"]
    pub_launches = summed(pub, lambda n: n in ("train_kernel", "inference_kernel"))
    pub_f32_launches = summed(pub, lambda n: n == "train_f32_policy")
    pub_ncf_launches = summed(pub_ncf["row"]["invocations"])
    opt_launches = summed(options["invocations"])
    hpo_launches = hpo_pmgt["row"]["launches"]
    export_launches = summed(hpo_ncf["row"]["export_invocations"])
    kernels = []
    for name, source, replaces, row, rows, launches in (
        ("dual_attention_fwd_sm", K1_SOURCE, K1_REPLACES, pick(checks, 3072),
         [r for r in checks if r["dtype"] == "float32"],
         {"serving": n_launches, "training": train["k1_launches"],
          "train_pmgt_cli": cli_launches["k1"],
          "pmgt_ncf_train": pncf_launches["train"]["k1"],
          "pmgt_ncf_evaluate": pncf_launches["evaluate"]["k1"],
          "pmgt_ncf_serve": pncf_launches["serve"]["k1"],
          "train_pmgt_ncf_cli": pncf_cli["k1"],
          "published_pmgt_bf16": pub_launches["k1"],
          "published_pmgt_f32_policy": pub_f32_launches["k1"],
          "published_pmgt_ncf_bf16": pub_ncf_launches["k1"],
          "options": opt_launches["k1"],
          "hpo_pmgt_trials": hpo_launches["k1"],
          "hpo_ncf_exports": export_launches["k1"],
          "scale": scale["launches"]["k1"],
          "quality_vg": quality["launches"]["k1"],
          "reproduce_fixture": quality["reproduce_launches"]["k1"],
          "evidence_hpo": evidence["launches"]["k1"],
          "multi_rank": multi["launches"]["k1"]}),
        ("dual_attention_bwd_sm", K2_SOURCE, K2_REPLACES, pick(k2_checks, 3072), k2_checks,
         {"serving": kern["row"]["k2_launches"], "training": train["k2_launches"],
          "train_pmgt_cli": cli_launches["k2"],
          "pmgt_ncf_train": pncf_launches["train"]["k2"],
          "pmgt_ncf_evaluate": pncf_launches["evaluate"]["k2"],
          "pmgt_ncf_serve": pncf_launches["serve"]["k2"],
          "train_pmgt_ncf_cli": pncf_cli["k2"],
          "published_pmgt_bf16": pub_launches["k2"],
          "published_pmgt_f32_policy": pub_f32_launches["k2"],
          "published_pmgt_ncf_bf16": pub_ncf_launches["k2"],
          "options": opt_launches["k2"],
          "hpo_pmgt_trials": hpo_launches["k2"],
          "hpo_ncf_exports": export_launches["k2"],
          "scale": scale["launches"]["k2"],
          "quality_vg": quality["launches"]["k2"],
          "reproduce_fixture": quality["reproduce_launches"]["k2"],
          "evidence_hpo": evidence["launches"]["k2"],
          "multi_rank": multi["launches"]["k2"]}),
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
    # K1 and K2 at the other lanes of their paths: (warm ms, cold ms, bound ms)
    at = lambda r: [r["ms"], r["cold_ms"], r["bound_ms"]]  # noqa: E731
    kernels[0]["ms_cold_bound_by_lanes"] = {
        str(r["N"]): at(r) for r in checks
        if r["dtype"] == "float32" and not r["keep_masks"] and r["N"] in (4000, 65536)}
    kernels[1]["ms_cold_bound_by_lanes"] = {
        str(r["N"]): at(r) for r in k2_checks if r["keep_masks"] and r["N"] == 256}
    # bf16 operands at the published shapes: (warm ms, cold ms, bound ms at
    # 2-byte operands, max abs err, its limit)
    bf16 = lambda r: [*at(r), r["max_abs_err"], r["limit"]]  # noqa: E731
    key = lambda r: (f"d{r['d']}_N{r['N']}{'_keep' if r['keep_masks'] else ''}"  # noqa: E731
                     + ("" if r["beta"] == 0.5 else f"_beta{r['beta']:g}"))
    kernels[0]["bf16"] = {key(r): bf16(r) for r in checks if r["dtype"] == "bfloat16"}
    kernels[1]["bf16"] = {key(r): bf16(r) for r in k2_bf16}
    if any(k["launches"] == 0 for k in kernels):
        raise RuntimeError(f"a kernel was not launched on its path: {kernels}")
    results.update(kernels=kernels, slice_kernel=kern["row"],
                   slice_plain=ref["row"], train=train, train_routes=routes,
                   cross_layout=cross, public_op=public, cli=cli, ncf=ncf["row"],
                   pmgt_ncf=pncf["row"], dcn=dcn, downstream_cli=down_cli,
                   published_pmgt=published["row"], published_pmgt_ncf=pub_ncf["row"],
                   options=options, downstream_profile=down_busy,
                   multi_rank=multi["lines"], multi_rank_summary=multi["summary"],
                   multi_rank_studies=multi["studies"], feature_extraction=fx_row,
                   preprocess=pre["row"], hpo_pmgt=hpo_pmgt, hpo_ncf=hpo_ncf,
                   scale=scale["row"], scale_routes=scale["routes"], quality=quality,
                   evidence=evidence,
                   profile_sessions=prof_sessions,
                   command_s=time.perf_counter() - T_START)
    emit({"phase": "command_time", "seconds": results["command_s"]})
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


def cli() -> int:
    argv = sys.argv[1:]
    if argv[:1] == ["--multi-card"] and set(argv[1:]) <= set(MULTI_CARD_JOBS):
        return multi_card_main(tuple(argv[1:]) or MULTI_CARD_JOBS)
    if argv == ["--scale"]:
        return scale_main()
    seeds = argv[3:] if argv[2:3] == ["pmgt_ncf"] and argv[1:2] == ["TG"] else argv[2:]
    if (argv[:1] == ["--quality"] and len(argv) >= 2
            and (argv[1:] == ["int8"] or argv[1] in ("VG", "TG")
                 and all(a.isdigit() for a in seeds))):
        return quality_main(argv[1:])
    if argv[:1] == ["--evidence"] and len(argv) == 2 and argv[1] in EVIDENCE:
        return evidence_main(argv[1])
    if argv[:2] == ["--bisect", "dcn-frozen"] and len(argv) == 2:
        return bisect_main("dcn-frozen")
    if argv[:2] == ["--bisect", "dcn-frozen-seeds"] and all(a.isdigit() for a in argv[2:]):
        seeds = tuple(map(int, argv[2:])) or DCN_FROZEN_SEEDS
        return bisect_main("dcn-frozen-seeds", seeds=seeds)
    if argv[:2] == ["--bisect", "dcn-frozen-bf16"] and all(a.isdigit() for a in argv[2:]):
        return bisect_main("dcn-frozen-bf16", seeds=tuple(map(int, argv[2:])) or DCN_BF16_SEEDS)
    if argv[:2] == ["--bisect", "neumf-pre"] and len(argv) == 3 and argv[2].isdigit():
        return bisect_main("neumf-pre", int(argv[2]))
    if argv:
        print(f"unknown arguments {argv}: none, --scale, --quality VG|TG [seed ...], "
              f"--quality TG pmgt_ncf [seed ...], --quality int8, "
              f"--evidence {'|'.join(EVIDENCE)}, --bisect dcn-frozen|neumf-pre SEED, "
              f"--bisect dcn-frozen-seeds|dcn-frozen-bf16 [seed ...], "
              f"or --multi-card "
              f"[{'] ['.join(MULTI_CARD_JOBS)}]", file=sys.stderr)
        return 2
    return main()


if __name__ == "__main__":
    sys.exit(cli())
