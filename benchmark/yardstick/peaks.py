"""The H100's published peaks and the dual-attention kernels' least times.

``k1_bound_s`` and ``k2_bound_s`` are frozen copies of ``k1_bound_ms`` and
``k2_bound_ms`` in ``chip_smoke.py`` (sha256 07ee127fb595b8ccdbaac2fb87e7
7fb38030a3d6eddd2e033d06f01f0c53df4e), in seconds. Peaks: NVIDIA's data
sheet for the H100 SXM, dense, at its 700 W limit.

``attention_calls`` gives the dual attention that one unit of work needs,
from the configuration and the mix alone, as K1 and K2 calls, so a
kernel's roofline does not depend on how the program launches it.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # float32 outside the tensor cores (TF32 off)
BF16_FLOPS = 989e12  # bf16 tensor cores, dense

PEAK_FLOPS = {"float32": F32_FLOPS, "bfloat16": BF16_FLOPS}
ELEM_BYTES = {"float32": 4, "bfloat16": 2}


def k1_bound_s(s: int, n: int, d: int, elem_bytes: int, mask_bytes: int) -> float:
    """Least time of one K1 call: q, k, v, c read and the output written
    once, the [N, S] f32 additive mask and the two [S, N, S] keep masks
    read once, against the f32 work (c·cᵀ, q·kᵀ, P·v: 6·S²·N·d, plus the S
    norms), whichever is longer."""
    nbytes = 5 * s * n * d * elem_bytes + 4 * n * s + 2 * s * n * s * mask_bytes
    flops = 6 * s * s * n * d + 2 * s * n * d
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS)


def k2_bound_s(s: int, n: int, d: int, elem_bytes: int, mask_bytes: int) -> float:
    """Least time of one K2 call: q, k, v, c, g, the mask and the keep
    masks read once, dq, dk, dv, dc written once, against the f32 work of
    its seven S×S×d products (14·S²·N·d, plus the S norms)."""
    nbytes = 9 * s * n * d * elem_bytes + 4 * n * s + 2 * s * n * s * mask_bytes
    flops = 14 * s * s * n * d + 2 * s * n * d
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS)


def attention_calls(cfg: dict, lanes: int, training: bool) -> dict:
    """{"k1": [...], "k2": [...]}: the (S, N, d, operand bytes, keep-mask
    bytes) of the dual attention that ``lanes`` sequences through the
    encoder need, one entry a layer; with ``training`` the backward (K2)
    too and the keep masks at one byte an element (a bool mask, the least
    a stored mask takes). Operands in the configuration's precision."""
    heads = cfg["num_attention_heads"]
    call = (1 + cfg["max_ctx_neigh"], lanes * heads, cfg["hidden_size"] // heads,
            ELEM_BYTES[cfg["precision"]], 1 if training else 0)
    layers = [call] * cfg["num_hidden_layers"]
    return {"k1": layers, "k2": layers if training else []}
