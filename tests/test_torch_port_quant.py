"""The port's feature-table storage (``pmgt_tpu_torch/core/quant.py``)
against the JAX package's ``pmgt_tpu/core/quant.py``.

- int8: codes and scales equal JAX's ``quantize_table`` bit for bit
  (all-zero rows, negative rows, rows whose max sits on a tie);
- bf16 storage equals the ``ml_dtypes`` cast JAX makes, bit for bit;
- ``table_rows`` / ``dense_table`` in f32 and bf16 equal JAX's on the same
  tables (f32 exactly; bf16 dequantization exactly: one rounding of an
  exact product either way);
- ``prepare_feat_tables`` for the three storages, and their sizes.
"""
from __future__ import annotations

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from pmgt_tpu.core import quant as jquant
from pmgt_tpu_torch.core.quant import (
    QuantizedTable,
    dense_table,
    is_quantized,
    prepare_feat_tables,
    quantize_table,
    table_nbytes,
    table_rows,
    table_shape,
)


def _table(seed, n=40, f=24):
    rs = np.random.default_rng(seed)
    t = (rs.standard_normal((n, f)) * rs.uniform(0.01, 10.0, (n, 1))).astype(np.float32)
    t[:2] = 0.0  # <pad>, <mask>
    t[2] = -np.abs(t[2])  # a row whose max magnitude is negative
    t[3, :] = 0.5
    t[3, 0] = 127.0 / 2  # x / scale lands on .5 ties
    return t


def _bf16_bits(x) -> np.ndarray:
    return np.asarray(x).view(np.uint16)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_codes_and_scales_equal_jax(seed):
    t = _table(seed)
    want = jquant.quantize_table(t)
    got = quantize_table(t)
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy().view(np.uint32),
                                  np.asarray(want.scale).view(np.uint32))
    assert (got.q[:2] == 0).all() and (got.scale[:2] == 1.0).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_storage_equals_the_ml_dtypes_cast(seed):
    t = _table(seed)
    t[5, :4] = [1.00390625, 1.01171875, -3.0078125, 65504.5]  # halfway cases
    (got,) = prepare_feat_tables([t], "bfloat16", "cpu")
    assert got.dtype == torch.bfloat16
    want = t.astype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(_bf16_bits(got.view(torch.int16).numpy()),
                                  _bf16_bits(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_table_rows_and_dense_table_equal_jax(dtype, storage):
    t = _table(3)
    ids = np.array([[2, 5, 0], [39, 3, 1]], np.int32)
    jt = {"float32": jnp.asarray(t), "bfloat16": jnp.asarray(t.astype(ml_dtypes.bfloat16)),
          "int8": jquant.quantize_table(t)}[storage]
    if storage == "int8":
        jt = jquant.QuantizedTable(jnp.asarray(jt.q), jnp.asarray(jt.scale))
    (pt,) = prepare_feat_tables([t], storage, "cpu")
    assert is_quantized(pt) == (storage == "int8")
    assert table_shape(pt) == t.shape
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    rows = table_rows(pt, torch.from_numpy(ids.astype(np.int64)), tdt)
    dense = dense_table(pt, tdt)
    jrows = jquant.table_rows(jt, jnp.asarray(ids), jnp.dtype(dtype))
    jdense = jquant.dense_table(jt, jnp.dtype(dtype))
    for a, b in ((rows, jrows), (dense, jdense)):
        assert a.dtype == tdt and str(b.dtype) == dtype
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))


def test_int8_error_bound_and_sizes():
    t = _table(4)
    q = quantize_table(t)
    err = np.abs(dense_table(q).numpy() - t)
    bound = np.max(np.abs(t), axis=1, keepdims=True) / 254.0
    assert (err <= bound + 1e-6).all()
    f32, bf16, i8 = (prepare_feat_tables([t], d, "cpu")[0] for d in ("float32", "bfloat16", "int8"))
    n, f = t.shape
    assert (table_nbytes(f32), table_nbytes(bf16), table_nbytes(i8)) == (4 * n * f, 2 * n * f,
                                                                         n * f + 4 * n)
    assert isinstance(i8, QuantizedTable) and i8.to("cpu").q.data_ptr() == i8.q.data_ptr()
    with pytest.raises(ValueError, match="feat_tables_dtype"):
        prepare_feat_tables([t], "float16", "cpu")
