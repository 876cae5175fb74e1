"""Native (C++) preprocessing builders, loaded with ctypes (counterpart of
``pmgt_tpu/native/__init__.py``):

- ``co_review_edges_native``: the co-review pair counter of the item-graph
  build (``co_review.cpp``);
- ``build_alias_tables_native``: the Vose alias tables of the padded-CSR
  graph (``alias_builder.cpp``).

Each source compiles at first use, with the host compiler, into a shared
library under ``build/pmgt_tpu_torch/`` at the repository root (a
directory ``.gitignore`` lists), never beside the source:

    g++ -O3 -shared -fPIC -o lib<name>-<hash>.so <name>.cpp

The file name carries a hash of the source and the flags, so an edited
source rebuilds. The compiler writes to a temporary file that is renamed
into place, so concurrent first builds never load a half-written file.
There is no fallback: a missing compiler, a failed build or a failed load
raises with the compiler's output. The one ``None`` is
``co_review_edges_native``'s above ``max_pairs``, a memory cap: the caller
then counts with scipy, as the JAX package does.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, Optional, Tuple

import numpy as np

SRC_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(SRC_DIR)), "build", "pmgt_tpu_torch"
)
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)
# C entry -> (library, argtypes, restype); a CPU test holds these against
# the ``extern "C"`` declarations of the sources.
C_ENTRIES = {
    "co_review_build": (
        "co_review",
        [_i32p, _i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64],
        ctypes.c_int64,
    ),
    "co_review_fetch": ("co_review", [_i32p, _i32p, _i32p], None),
    "build_alias_tables": (
        "alias_builder",
        [_f32p, _i32p, ctypes.c_int64, ctypes.c_int64, _f32p, _i32p],
        None,
    ),
}

_LIBS: Dict[str, ctypes.CDLL] = {}
# co_review.cpp stages its edges in globals between the two calls, and
# ctypes releases the interpreter lock during each: one counter at a time.
_CO_REVIEW_LOCK = threading.Lock()


def lib_path(src: str, build_dir: str = BUILD_DIR) -> str:
    """Where the library of ``src`` lives, keyed by its source and flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(build_dir, f"lib{stem}-{h.hexdigest()[:16]}.so")


def build_library(src: str, build_dir: str = BUILD_DIR) -> str:
    """Compile ``src`` unless its library exists; returns the library's
    path. Raises ``RuntimeError`` with the compiler's output when the
    build fails."""
    out = lib_path(src, build_dir)
    if os.path.exists(out):
        return out
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(
            ["g++", *CXX_FLAGS, "-o", tmp, src], capture_output=True, text=True
        )
    except FileNotFoundError as e:
        raise RuntimeError(
            "g++ not found: the native preprocessing builders are compiled "
            "from source at first use"
        ) from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"native build of {src} failed (g++ exit {proc.returncode}):\n"
            f"{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: concurrent builders race safely
    return out


def _load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (``<name>.cpp``), typed and built first
    if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(build_library(os.path.join(SRC_DIR, f"{name}.cpp")))
        for entry, (owner, argtypes, restype) in C_ENTRIES.items():
            if owner == name:
                fn = getattr(lib, entry)
                fn.argtypes = argtypes
                fn.restype = restype
        _LIBS[name] = lib
    return lib


def co_review_edges_native(
    items: np.ndarray,
    users: np.ndarray,
    min_common: int,
    max_pairs: int = 2_000_000_000,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Co-review pair counting (the hot part of the item-graph build):
    ``items`` / ``users`` are parallel int32 arrays of (item, user)
    records, duplicates allowed. Returns int32 (src, dst, common_count)
    with count >= ``min_common`` and src < dst, in the builder's hash
    order; or None when the pair workload (sum over users of n_u·(n_u-1)/2
    after dedup) exceeds ``max_pairs``."""
    lib = _load("co_review")
    items = np.ascontiguousarray(items, dtype=np.int32)
    users = np.ascontiguousarray(users, dtype=np.int32)
    if items.shape != users.shape or items.ndim != 1:
        raise ValueError(f"items {items.shape} and users {users.shape} must be equal 1-d")
    with _CO_REVIEW_LOCK:
        n_edges = lib.co_review_build(
            items.ctypes.data_as(_i32p), users.ctypes.data_as(_i32p),
            len(items), int(min_common), int(max_pairs),
        )
        if n_edges < 0:
            return None
        src = np.empty(n_edges, np.int32)
        dst = np.empty(n_edges, np.int32)
        count = np.empty(n_edges, np.int32)
        lib.co_review_fetch(
            src.ctypes.data_as(_i32p), dst.ctypes.data_as(_i32p),
            count.ctypes.data_as(_i32p),
        )
    return src, dst, count


def build_alias_tables_native(
    nbr_logits: np.ndarray, degrees: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Vose alias tables of every row over softmax(its first ``degree``
    logits) → (alias_prob float32 [n, d], alias_idx int32 [n, d]); rows of
    degree 0 or 1 and the padding slots get (1.0, 0)."""
    lib = _load("alias_builder")
    weights = np.ascontiguousarray(nbr_logits, dtype=np.float32)
    deg = np.ascontiguousarray(degrees, dtype=np.int32)
    n, d = weights.shape
    if deg.shape != (n,) or (n and (deg.min() < 0 or deg.max() > d)):
        raise ValueError(f"degrees {deg.shape} must be [n={n}] in [0, {d}]")
    prob = np.empty((n, d), np.float32)
    idx = np.empty((n, d), np.int32)
    lib.build_alias_tables(
        weights.ctypes.data_as(_f32p), deg.ctypes.data_as(_i32p), n, d,
        prob.ctypes.data_as(_f32p), idx.ctypes.data_as(_i32p),
    )
    return prob, idx
