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
compute dtype). With ``--shard-feat-tables`` a rank holds its row block
of each table (``ShardedTable``, codes and scales alike for int8) and
``tables_rows`` reads rows of every table across the ranks with one
exchange of ids (``core/mesh.gather_rows``).
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from pmgt_tpu_torch.core.mesh import gather_rows, shard_rows


class QuantizedTable(NamedTuple):
    """Symmetric per-row int8 quantized [N, F] table."""

    q: torch.Tensor  # int8 [N, F]
    scale: torch.Tensor  # float32 [N, 1]

    def to(self, device) -> "QuantizedTable":
        return QuantizedTable(self.q.to(device), self.scale.to(device))

    @property
    def shape(self):
        return self.q.shape


class ShardedTable(NamedTuple):
    """A table row-sharded over a data-parallel group: this rank's block
    (rows padded to a multiple of the world size) and the group."""

    local: Union[torch.Tensor, QuantizedTable]
    mesh: Any  # core.mesh.Mesh
    rows: int  # the table's rows before padding

    @property
    def shape(self):
        return (self.rows,) + tuple(self.local.shape[1:])


Table = Union[torch.Tensor, QuantizedTable, ShardedTable]

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


def _blocks(table) -> tuple:
    local = table.local
    return (local.q, local.scale) if is_quantized(local) else (local,)


def tables_rows(tables: Sequence[Table], ids: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> List[torch.Tensor]:
    """``table_rows`` of each table. The row-sharded ones are gathered
    across the ranks with one exchange of ids (they share a row layout)."""
    sharded = [t for t in tables if isinstance(t, ShardedTable)]
    got = iter(())
    if sharded:
        got = iter(gather_rows(sharded[0].mesh, sum((_blocks(t) for t in sharded), ()), ids))
    out = []
    for t in tables:
        if not isinstance(t, ShardedTable):
            out.append(table_rows(t, ids, dtype))
        elif is_quantized(t.local):
            q, scale = next(got), next(got)
            dt = torch.float32 if dtype is None else dtype
            out.append(q.to(dt) * scale.to(dt))
        else:
            rows = next(got)
            out.append(rows if dtype is None else rows.to(dtype))
    return out


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
    """Device bytes the table holds (codes and scales for int8; a sharded
    table's block)."""
    if isinstance(table, ShardedTable):
        table = table.local
    parts = (table.q, table.scale) if is_quantized(table) else (table,)
    return sum(p.numel() * p.element_size() for p in parts)


def prepare_feat_tables(
    tables: Sequence[np.ndarray], dtype: str, device, shard=None
) -> list:
    """Cast or quantize the frozen feature tables on the host and move them
    to ``device``: ``dtype`` in {"float32", "bfloat16", "int8"}. With
    ``shard`` (a ``core.mesh.Mesh``) each becomes a ``ShardedTable`` of
    the rank's padded row block; an int8 table shards its codes and
    scales alike."""
    if dtype not in TABLE_DTYPES:
        raise ValueError(f"invalid feat_tables_dtype {dtype}")
    out = []
    for t in tables:
        if dtype == "int8":
            x = quantize_table(t)
            if shard is not None:
                x = QuantizedTable(shard_rows(shard, x.q), shard_rows(shard, x.scale))
        else:
            x = torch.as_tensor(np.asarray(t, np.float32))
            if dtype == "bfloat16":
                x = x.to(torch.bfloat16)  # round to nearest even
            if shard is not None:
                x = shard_rows(shard, x)
        x = x.to(device)
        out.append(x if shard is None else ShardedTable(x, shard, int(np.shape(t)[0])))
    return out
