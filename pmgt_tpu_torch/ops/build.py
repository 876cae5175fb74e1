"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles, at first use, into a shared library with
a plain C interface under ``build/pmgt_tpu_torch/`` at the repository
root (a directory ``.gitignore`` lists):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o lib<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the sources and flags, so an edited
kernel rebuilds. ``build_all`` starts one ``nvcc`` per source, all at
once. The ptxas report (registers, spills) is kept beside each library
as ``.log``. There is no fallback: a missing ``nvcc`` or a failed build
raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable, Optional

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build",
    "pmgt_tpu_torch",
)
KERNELS = ("dual_attention_fwd", "dual_attention_bwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    toolkit = os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"
    )
    if path is None and os.path.exists(toolkit):
        path = toolkit
    if path is None:
        raise RuntimeError(
            "nvcc not found on PATH or under $CUDA_HOME/bin; the port's "
            "CUDA kernels are built from source at first use"
        )
    return path


def _source(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def lib_path(name: str) -> str:
    """Where ``name``'s library lives, keyed by its sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for f in [f"{name}.cu"] + headers:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every kernel whose library is missing, one ``nvcc`` per
    source, all started together. Returns {name: library path}."""
    names = tuple(KERNELS if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = {}
    for name in names:
        out = lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, _source(name)]
        jobs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp,
            out,
        )
    failed = []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        with open(out[: -len(".so")] + ".log", "w") as f:
            f.write(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: concurrent builders race safely
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {name: lib_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_all([name])[name]
        lib = ctypes.CDLL(path)
        _LIBS[name] = lib
    return lib
