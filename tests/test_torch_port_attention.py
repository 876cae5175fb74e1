"""Parity of the port's seq-major dual-attention forward (K1) with the JAX
package's Pallas kernel.

The plain PyTorch version ``dual_attention_sm_reference`` is held against
``pmgt_tpu.ops.dual_attention._fused_sm`` run in Pallas interpret mode on
the CPU, on the same numpy inputs: with and without explicit keep masks,
at N not a multiple of the TPU block (256), with masked keys and a zero
context row. The CUDA kernel itself is checked on the card
(``test_kernel_matches_plain_on_gpu`` and ``chip_smoke.py``).

Tolerance: f32, atol 2e-5 (both sides compute in f32; sums run in
another order).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmgt_tpu.models.pmgt import dual_attention_xla
from pmgt_tpu.ops.dual_attention import _fused_sm
from pmgt_tpu_torch.models.pmgt import dual_attention_plain
from pmgt_tpu_torch.ops.dual_attention import (
    dual_attention_sm,
    dual_attention_sm_reference,
)

ATOL = 2e-5
BIG_NEG = float(np.finfo(np.float32).min)


def _inputs(seed, s, n, d, keep=0.9):
    rs = np.random.default_rng(seed)
    q, k, v, c = (rs.standard_normal((s, n, d)).astype(np.float32) for _ in range(4))
    c[0, 0] = 0.0  # a zero context row: the cosine divides by max(., 1e-12)
    mask = np.zeros((n, s), np.float32)
    mask[:, -1] = BIG_NEG  # last key masked everywhere
    if n > 1:
        mask[1, 2:] = BIG_NEG  # a sequence with only its first two keys
    m1 = rs.random((s, n, s)) < keep
    m2 = rs.random((s, n, s)) < keep
    return q, k, v, c, mask, m1, m2


def _jax(q, k, v, c, mask, m1, m2, beta, keep, use_dropout):
    out = _fused_sm(
        *(jnp.asarray(x) for x in (q, k, v, c, mask, m1, m2)),
        float(beta), float(keep), bool(use_dropout),
    )
    return np.asarray(out)


def _torch(fn, q, k, v, c, mask, m1, m2, beta, keep, use_dropout):
    t = [None if x is None else torch.from_numpy(np.asarray(x))
         for x in (q, k, v, c, mask, m1, m2)]
    return fn(*t, beta=beta, keep=keep, use_dropout=use_dropout).numpy()


@pytest.mark.parametrize(
    "s,n,d,beta,use_dropout",
    [
        (6, 300, 32, 0.5, False),  # N not a multiple of the 256 block
        (6, 300, 32, 0.5, True),  # with explicit keep masks
        (4, 17, 64, 0.3, False),
        (1, 5, 32, 0.7, True),  # a single position: only self-attention
    ],
)
def test_reference_matches_pallas_sm(s, n, d, beta, use_dropout):
    args = _inputs(s * 1000 + n, s, n, d)
    keep = 0.9
    want = _jax(*args, beta, keep, use_dropout)
    got = _torch(dual_attention_sm_reference, *args, beta, keep, use_dropout)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_reference_float_keep_masks_match_bool():
    """Keep masks may come as bool, uint8 or float32; all give the same
    output."""
    q, k, v, c, mask, m1, m2 = _inputs(7, 6, 40, 32)
    outs = [
        _torch(dual_attention_sm_reference, q, k, v, c, mask,
               m1.astype(dt), m2.astype(dt), 0.5, 0.8, True)
        for dt in (bool, np.uint8, np.float32)
    ]
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])


def test_wrapper_on_cpu_is_the_reference():
    args = _inputs(3, 6, 50, 32)
    before = dual_attention_sm.launches
    a = _torch(dual_attention_sm, *args, 0.5, 0.9, True)
    b = _torch(dual_attention_sm_reference, *args, 0.5, 0.9, True)
    np.testing.assert_array_equal(a, b)
    # The launch counter counts kernel launches only.
    assert dual_attention_sm.launches == before


def test_plain_batch_major_matches_xla():
    """``dual_attention_plain`` (the "xla" route) against the JAX
    package's ``dual_attention_xla`` on [B, h, S, d] inputs."""
    rs = np.random.default_rng(11)
    b, h, s, d = 5, 2, 6, 16
    q, k, v, c = (rs.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(4))
    c[0, 0, 0] = 0.0
    mask = np.zeros((b, 1, 1, s), np.float32)
    mask[:, ..., -2:] = BIG_NEG
    want = np.asarray(
        dual_attention_xla(
            *(jnp.asarray(x) for x in (q, k, v, c, mask)),
            beta=0.4, dropout_rate=0.0, deterministic=True, dropout_rng=None,
        )
    )
    got = dual_attention_plain(
        *(torch.from_numpy(x) for x in (q, k, v, c, mask)), beta=0.4
    ).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_plain_and_seq_major_routes_agree():
    q, k, v, c, mask, _, _ = _inputs(5, 6, 24, 32)
    sm = _torch(dual_attention_sm_reference, q, k, v, c, mask, None, None,
                0.5, 1.0, False)
    to_bm = lambda x: torch.from_numpy(x).permute(1, 0, 2)[:, None]  # noqa: E731
    bm = dual_attention_plain(
        to_bm(q), to_bm(k), to_bm(v), to_bm(c),
        torch.from_numpy(mask)[:, None, None, :], beta=0.5,
    )
    np.testing.assert_allclose(bm[:, 0].permute(1, 0, 2).numpy(), sm, atol=ATOL)


# (N, S, d) on the card: the serving shapes, then edges of the tiling (one
# sequence, ragged tiles, 32-lane key groups for S > 8, d not a multiple
# of 128, the largest S x d, where two stages do not fit in shared memory).
GPU_SHAPES = [(768, 6, 128), (256, 6, 128), (1, 1, 32), (37, 9, 96),
              (3071, 32, 256), (3071, 8, 32), (37, 2, 256), (1, 32, 96)]


@pytest.mark.gpu
@pytest.mark.parametrize("n,s,d", GPU_SHAPES)
def test_kernel_matches_plain_on_gpu(n, s, d):
    """The CUDA kernel against the plain version, f32 and bf16, without
    keep masks and with bool and f32 keep masks (needs a card and nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args = _inputs(n, s, n, d)
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        for use_dropout, mdt in ((False, torch.bool), (True, torch.bool),
                                 (True, torch.float32)):
            q, k, v, c = (torch.from_numpy(x).cuda().to(dt) for x in args[:4])
            mask = torch.from_numpy(args[4]).cuda()
            m1, m2 = (torch.from_numpy(x).cuda().to(mdt) for x in args[5:])
            out = dual_attention_sm(q, k, v, c, mask, m1, m2, 0.5, 0.9,
                                    use_dropout)
            torch.cuda.synchronize()
            ref = dual_attention_sm_reference(
                q.float(), k.float(), v.float(), c.float(), mask, m1, m2,
                0.5, 0.9, use_dropout,
            )
            err = (out.float() - ref).abs().max().item()
            if dt == torch.bfloat16:
                err /= ref.abs().max().item()
            assert err <= tol, (n, s, d, dt, use_dropout, mdt, err)
