"""Storage of the frozen multimodal feature tables (counterpart of
``pmgt_tpu/core/quant.py``): float32, bfloat16 or symmetric per-row int8.

    scale[n] = max(|table[n, :]|) / 127        (f32, one per row; 1.0 for
                                                an all-zero row)
    q[n, :]  = round(table[n, :] / scale[n])   (int8, round half to even)
    dequant  = q * scale

The host-side codes and scales are the JAX package's, bit for bit (the
same numpy expressions). bfloat16 storage rounds to nearest even, as the
``ml_dtypes`` cast does. Model code reads every table through
``table_rows`` / ``dense_table``, which take plain tensors and
``QuantizedTable`` alike and dequantize in the dtype asked for (pass the
compute dtype). Row sharding over several cards waits for the multi-GPU
port.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch


class QuantizedTable(NamedTuple):
    """Symmetric per-row int8 quantized [N, F] table."""

    q: torch.Tensor  # int8 [N, F]
    scale: torch.Tensor  # float32 [N, 1]

    def to(self, device) -> "QuantizedTable":
        return QuantizedTable(self.q.to(device), self.scale.to(device))

    @property
    def shape(self):
        return self.q.shape


Table = Union[torch.Tensor, QuantizedTable]

TABLE_DTYPES = ("float32", "bfloat16", "int8")


def quantize_table(table: np.ndarray) -> QuantizedTable:
    """Host-side symmetric per-row int8 quantization (CPU tensors)."""
    t = np.asarray(table, dtype=np.float32)
    amax = np.max(np.abs(t), axis=1, keepdims=True)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(t / scale), -127, 127).astype(np.int8)
    return QuantizedTable(torch.from_numpy(q), torch.from_numpy(scale))


def is_quantized(table: Table) -> bool:
    return isinstance(table, QuantizedTable)


def table_rows(
    table: Table, ids: torch.Tensor, dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """Gather rows ``table[ids]`` -> [..., F]. A quantized table gathers
    int8 rows and their scales and dequantizes in ``dtype`` (default
    float32); a plain table's rows are cast to ``dtype`` if given."""
    if is_quantized(table):
        dt = torch.float32 if dtype is None else dtype
        return table.q[ids].to(dt) * table.scale[ids].to(dt)
    rows = table[ids]
    return rows if dtype is None else rows.to(dtype)


def dense_table(table: Table, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The full [N, F] table (dequantized if needed), in ``dtype`` if
    given."""
    if is_quantized(table):
        dt = torch.float32 if dtype is None else dtype
        return table.q.to(dt) * table.scale.to(dt)
    return table if dtype is None else table.to(dtype)


def table_shape(table: Table):
    return tuple(table.shape)


def table_nbytes(table: Table) -> int:
    """Device bytes the table holds (codes and scales for int8)."""
    parts = (table.q, table.scale) if is_quantized(table) else (table,)
    return sum(p.numel() * p.element_size() for p in parts)


def prepare_feat_tables(
    tables: Sequence[np.ndarray], dtype: str, device
) -> list:
    """Cast or quantize the frozen feature tables on the host and move them
    to ``device``: ``dtype`` in {"float32", "bfloat16", "int8"}."""
    if dtype not in TABLE_DTYPES:
        raise ValueError(f"invalid feat_tables_dtype {dtype}")
    out = []
    for t in tables:
        if dtype == "int8":
            out.append(quantize_table(t).to(device))
            continue
        x = torch.as_tensor(np.asarray(t, np.float32))
        if dtype == "bfloat16":
            x = x.to(torch.bfloat16)  # round to nearest even
        out.append(x.to(device))
    return out
