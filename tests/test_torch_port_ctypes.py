"""The ctypes signatures of the kernel libraries' C entries, held against
their ``extern "C"`` declarations in ``pmgt_tpu_torch/ops/csrc/*.cu``, and
those of the native preprocessing builders against
``pmgt_tpu_torch/native/*.cpp``.

ctypes checks nothing: a pointer typed as ``c_int`` is cut to 32 bits and
a ``long long`` typed as ``c_int`` shifts every later argument, silently.
So the declarations are parsed here (no compiler needed) and each
parameter's kind is compared with ``entry_argtypes``.
"""
import ctypes
import glob
import os
import re

import pytest

from pmgt_tpu_torch import native
from pmgt_tpu_torch.ops import build
from pmgt_tpu_torch.ops.dual_attention import C_ENTRIES, entry_argtypes


def _extern_c_declarations() -> dict:
    """{name: [parameter declarations]} of every function defined inside an
    ``extern "C" { ... }`` block of the kernel sources."""
    found = {}
    for path in sorted(glob.glob(os.path.join(build.CSRC, "*.cu"))):
        with open(path) as f:
            text = re.sub(r"//[^\n]*", "", f.read())
        for block in re.findall(r'extern\s+"C"\s*\{(.*)\}', text, re.S):
            for name, params in re.findall(
                r"\b(?:int|void)\s+(\w+)\s*\(([^)]*)\)\s*\{", block
            ):
                found[name] = [p.strip() for p in params.split(",")]
    return found


def _ctype_of(param: str):
    """The ctypes type a C parameter declaration calls for."""
    if "*" in param:
        return ctypes.c_void_p
    words = param.replace("const", "").split()[:-1]  # drop the name
    kinds = {("int",): ctypes.c_int, ("long", "long"): ctypes.c_longlong,
             ("float",): ctypes.c_float}
    return kinds[tuple(words)]


def test_every_c_entry_has_a_signature():
    """The wrappers type every C entry the sources define, and no other."""
    assert set(_extern_c_declarations()) == set(C_ENTRIES)
    for lib, _ in C_ENTRIES.values():
        assert lib in build.KERNELS


@pytest.mark.parametrize("name", sorted(C_ENTRIES))
def test_c_entry_matches_ctypes_argtypes(name):
    """Parameter count and kind of each C entry equal its ctypes argtypes:
    pointer -> c_void_p, int -> c_int, long long -> c_longlong, float ->
    c_float."""
    params = _extern_c_declarations()[name]
    want = [_ctype_of(p) for p in params]
    got = entry_argtypes(C_ENTRIES[name][1])
    assert len(got) == len(want), (name, len(got), len(want))
    for i, (p, g, w) in enumerate(zip(params, got, want)):
        assert g is w, (name, i, p, g, w)


# ---- the native preprocessing builders (pmgt_tpu_torch/native/*.cpp) -------

def _native_declarations() -> dict:
    """{name: (return type, [parameter declarations])} of every function
    defined inside an ``extern "C"`` block of the native sources."""
    found = {}
    for path in sorted(glob.glob(os.path.join(native.SRC_DIR, "*.cpp"))):
        with open(path) as f:
            text = re.sub(r"//[^\n]*", "", f.read())
        for block in re.findall(r'extern\s+"C"\s*\{(.*)\}', text, re.S):
            for ret, name, params in re.findall(
                r"\b(int64_t|int32_t|void)\s+(\w+)\s*\(([^)]*)\)\s*\{", block
            ):
                found[name] = (ret, [p.strip() for p in params.split(",")])
    return found


_NATIVE_SCALARS = {"int64_t": ctypes.c_int64, "int32_t": ctypes.c_int32,
                   "float": ctypes.c_float}


def _native_ctype_of(param: str):
    """The ctypes type a native C parameter (or return type) calls for: a
    typed pointer for ``T*``, the fixed-width scalar otherwise."""
    words = param.replace("const", "").replace("*", " * ").split()
    if "*" in words:
        return ctypes.POINTER(_NATIVE_SCALARS[words[0]])
    return _NATIVE_SCALARS[words[0]]


def test_every_native_c_entry_has_a_signature():
    assert set(_native_declarations()) == set(native.C_ENTRIES)
    for lib, _, _ in native.C_ENTRIES.values():
        assert os.path.exists(os.path.join(native.SRC_DIR, f"{lib}.cpp"))


@pytest.mark.parametrize("name", sorted(native.C_ENTRIES))
def test_native_c_entry_matches_ctypes_argtypes(name):
    """Parameter count and kind, and the return type, of each native C
    entry equal its ctypes signature: int32_t* -> POINTER(c_int32), float*
    -> POINTER(c_float), int64_t -> c_int64, int32_t -> c_int32, void ->
    None."""
    ret, params = _native_declarations()[name]
    _, argtypes, restype = native.C_ENTRIES[name]
    want = [_native_ctype_of(p) for p in params]
    assert len(argtypes) == len(want), (name, len(argtypes), len(want))
    for i, (p, g, w) in enumerate(zip(params, argtypes, want)):
        assert g is w, (name, i, p, g, w)
    assert restype is (None if ret == "void" else _native_ctype_of(ret))
