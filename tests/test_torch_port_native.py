"""The port's native preprocessing builders (``pmgt_tpu_torch/native``)
against their plain versions and the JAX package's.

- co-review pair counting: the native counter, the port's scipy product
  (``data/preprocess.co_review_edges_scipy``) and
  ``pmgt_tpu.native.co_review_edges_native`` give the same (src, dst,
  count) sets on the inputs of ``tests/test_native.py``; above
  ``max_pairs`` the counter returns None;
- alias tables: the native builder, the port's Python loop
  (``graph/container.build_alias_tables_python``) and JAX's
  ``_build_alias_tables`` are bit-equal on random padded tables with
  degrees 0, 1 and the full width;
- the libraries are built under the build directory, never beside their
  sources, and a failed build raises with the compiler's output.
"""
import os
import shutil

import numpy as np
import pytest

from pmgt_tpu.graph.container import _build_alias_tables as jax_alias
from pmgt_tpu.native import co_review_edges_native as jax_co_review
from pmgt_tpu_torch import native
from pmgt_tpu_torch.data.preprocess import co_review_edges_scipy
from pmgt_tpu_torch.graph.container import (
    _build_alias_tables,
    build_alias_tables_python,
)


def _edge_set(edges):
    src, dst, count = edges
    return {(int(a), int(b)): int(c) for a, b, c in zip(src, dst, count)}


@pytest.mark.parametrize("min_common", [1, 3])
def test_co_review_native_scipy_and_jax_agree(min_common):
    rs = np.random.RandomState(7)
    m, n_items, n_users = 4000, 120, 60
    items = rs.randint(0, n_items, m).astype(np.int32)
    users = rs.randint(0, n_users, m).astype(np.int32)

    got = native.co_review_edges_native(items, users, min_common)
    assert got is not None and all(a.dtype == np.int32 for a in got)
    assert (got[0] < got[1]).all()
    uniq = np.unique(np.stack([items, users], 1), axis=0)  # the pipeline's dedup
    plain = co_review_edges_scipy(uniq[:, 0], uniq[:, 1], n_items, n_users, min_common)
    want = _edge_set(got)
    assert want == _edge_set(plain)
    assert want == _edge_set(jax_co_review(items, users, min_common))
    assert len(want) > 50 and min(want.values()) >= min_common


def test_co_review_max_pairs_cap_returns_none():
    items = np.arange(100, dtype=np.int32)
    users = np.zeros(100, np.int32)  # one user, 4,950 pairs
    assert native.co_review_edges_native(items, users, 1, max_pairs=100) is None
    full = native.co_review_edges_native(items, users, 1, max_pairs=4950)
    assert len(full[0]) == 4950


def _padded_table(seed, n, d):
    rng = np.random.default_rng(seed)
    degrees = rng.integers(0, d + 1, size=n).astype(np.int32)
    degrees[:3] = (0, 1, d)
    logits = np.full((n, d), -np.inf, np.float32)
    for r in range(n):
        logits[r, : degrees[r]] = rng.normal(size=degrees[r]) * 2.0
    return logits, degrees


@pytest.mark.parametrize("seed,n,d", [(0, 500, 40), (1, 64, 1), (2, 200, 7)])
def test_alias_tables_native_python_and_jax_bit_equal(seed, n, d):
    logits, degrees = _padded_table(seed, n, d)
    prob, idx = native.build_alias_tables_native(logits, degrees)
    assert prob.dtype == np.float32 and idx.dtype == np.int32
    for other in (build_alias_tables_python(logits, degrees),
                  jax_alias(logits, degrees), _build_alias_tables(logits, degrees)):
        np.testing.assert_array_equal(prob, other[0])
        np.testing.assert_array_equal(idx, other[1])
    # rows of degree 0 or 1 and the padding: (1.0, 0)
    pad = np.arange(d)[None, :] >= np.maximum(degrees, 1)[:, None]
    pad |= (degrees <= 1)[:, None]
    assert (prob[pad] == 1.0).all() and (idx[pad] == 0).all()


def test_alias_tables_reject_bad_degrees():
    logits, degrees = _padded_table(3, 8, 4)
    with pytest.raises(ValueError):
        native.build_alias_tables_native(logits, degrees[:5])
    with pytest.raises(ValueError):
        native.build_alias_tables_native(logits, degrees + 5)


def test_libraries_build_outside_the_sources():
    native.build_alias_tables_native(*_padded_table(4, 4, 2))
    native.co_review_edges_native(np.zeros(2, np.int32), np.zeros(2, np.int32), 1)
    for name in ("co_review", "alias_builder"):
        src = os.path.join(native.SRC_DIR, f"{name}.cpp")
        path = native.lib_path(src)
        assert os.path.dirname(path) == native.BUILD_DIR
        assert os.path.exists(path)
    assert not [f for f in os.listdir(native.SRC_DIR) if f.endswith(".so")]


def test_failed_build_raises_with_the_compiler_output(tmp_path):
    broken = tmp_path / "co_review.cpp"
    shutil.copy(os.path.join(native.SRC_DIR, "co_review.cpp"), broken)
    with open(broken, "a") as f:
        f.write("\nthis is not C++;\n")
    build_dir = tmp_path / "build"
    with pytest.raises(RuntimeError, match="error"):
        native.build_library(str(broken), str(build_dir))
    assert not any(p.suffix == ".so" for p in build_dir.iterdir())
    # the intact source builds, and a second call reuses its library
    good = tmp_path / "alias_builder.cpp"
    shutil.copy(os.path.join(native.SRC_DIR, "alias_builder.cpp"), good)
    path = native.build_library(str(good), str(build_dir))
    mtime = os.path.getmtime(path)
    assert native.build_library(str(good), str(build_dir)) == path
    assert os.path.getmtime(path) == mtime
