"""What the benchmark may import: nothing of JAX or of the JAX package
anywhere (top-level names compared whole: ``pmgt_tpu_torch`` begins with
``pmgt_tpu``), and nothing of the program in the reference and the
yardstick."""
from __future__ import annotations

import ast
import os

import pytest

from benchmark.harness import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "pmgt_tpu"}
FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(spec.BENCH_DIR) for f in fs
               if f.endswith(".py"))


def imported(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, spec.BENCH_DIR))
def test_no_jax(path):
    assert not set(imported(path)) & FORBIDDEN


@pytest.mark.parametrize("part", ["reference", "yardstick"])
def test_reference_stands_alone(part):
    for path in FILES:
        if os.sep + part + os.sep in path:
            assert "pmgt_tpu_torch" not in set(imported(path)), path
            assert "pmgt_tpu_torch" not in open(path, encoding="utf-8").read().replace(
                "``pmgt_tpu_torch/", ""), path


def test_nothing_reads_the_old_bench():
    """``bench.py`` and ``pmgt_tpu/bench/`` measured the JAX package."""
    for path in FILES:
        names = set(imported(path))
        assert "bench" not in names, path
