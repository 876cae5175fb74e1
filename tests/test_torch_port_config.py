"""The port's configuration, metrics and import boundary.

- ``PMGTConfig`` / ``SamplingConfig`` carry the JAX package's fields and
  defaults, field by field; ``TrainArgs`` the ones the serving and
  training slices read.
- ``roc_auc`` / ``stable_sigmoid`` agree with the JAX package's copies.
- ``pmgt_tpu_torch`` (and ``chip_smoke.py``) import neither JAX, click,
  sklearn, yaml nor any module of ``pmgt_tpu`` (the card machine has none
  of them): checked on the source and by importing every module of the
  package in a fresh interpreter where those imports fail. ``optuna`` is
  imported only inside the ``try`` of ``cli/hpo.py`` that falls back to the
  built-in study.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from pmgt_tpu.core import config as jconfig
from pmgt_tpu.metrics import ranking as jranking
from pmgt_tpu_torch.core import config as tconfig
from pmgt_tpu_torch.metrics import ranking as tranking

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "pmgt_tpu", "click", "sklearn",
             "yaml", "optuna")
# (file, module) pairs allowed inside a ``try`` block only
TRY_ONLY = {("pmgt_tpu_torch/cli/hpo.py", "optuna")}


def _fields(cls):
    return {f.name: (f.default if f.default is not dataclasses.MISSING
                     else f.default_factory()) for f in dataclasses.fields(cls)}


@pytest.mark.parametrize("name", ["PMGTConfig", "SamplingConfig"])
def test_configs_match_field_by_field(name):
    j, t = getattr(jconfig, name), getattr(tconfig, name)
    assert list(_fields(t)) == list(_fields(j))
    assert _fields(t) == _fields(j)
    assert dataclasses.asdict(t()) == dataclasses.asdict(j())


def test_config_properties_match():
    kw = dict(hidden_size=96, num_attention_heads=3, feat_hidden_sizes=[5, 7])
    j, t = jconfig.PMGTConfig(**kw), tconfig.PMGTConfig(**kw)
    assert (t.head_dim, t.all_head_size, t.num_feats, t.feat_hidden_sizes) == (
        j.head_dim, j.all_head_size, j.num_feats, j.feat_hidden_sizes)
    assert tconfig.PMGTConfig.from_dict(j.to_dict()) == t
    assert tconfig.SamplingConfig(max_ctx_neigh=7).seq_len == 8
    with pytest.raises(ValueError):
        tconfig.PMGTConfig(fusion_strategy="auto")
    with pytest.raises(ValueError):
        tconfig.PMGTConfig(hidden_size=10, num_attention_heads=3)


def test_train_args_subset_defaults():
    """The port's TrainArgs has every field of the JAX package's, in the
    same order, with the same defaults (the run, log and device fields
    arrived with the engine and CLI)."""
    j, t = _fields(jconfig.TrainArgs), _fields(tconfig.TrainArgs)
    assert list(t) == list(j)
    assert t == j
    args = tconfig.TrainArgs(extra={"hidden_size": 64})
    assert args.hidden_size == 64
    with pytest.raises(AttributeError):
        args.nope


def test_train_args_json_round_trips_across_packages(tmp_path):
    kw = dict(seed=4, run_id="abc", model_name="pmgt", tags=(("a", "b"),),
              mesh_shape=(1, 1), num_epochs=3, eval_interval=2,
              extra={"hidden_size": 64, "hop_sampling_sizes": [8, 4]})
    j, t = jconfig.TrainArgs(**kw), tconfig.TrainArgs(**kw)
    assert t.to_dict() == j.to_dict()
    j.save(str(tmp_path / "j.json"))
    t.save(str(tmp_path / "t.json"))
    assert (tmp_path / "j.json").read_text() == (tmp_path / "t.json").read_text()
    back = tconfig.TrainArgs.load(str(tmp_path / "j.json"))
    assert back.to_dict() == t.to_dict() and back.tags == (("a", "b"),)
    assert back.mesh_shape == (1, 1) and back.hop_sampling_sizes == [8, 4]
    assert jconfig.TrainArgs.load(str(tmp_path / "t.json")).to_dict() == j.to_dict()


@pytest.mark.parametrize("req,n", [(None, 10), ("auto", 60_000), ("auto", 50_000),
                                   ("gather_rows", 3), ("project_tables", 10**6)])
def test_resolve_fusion_strategy(req, n):
    assert tconfig.resolve_fusion_strategy(req, n) == jconfig.resolve_fusion_strategy(req, n)


def test_ranking_metrics_match():
    rs = np.random.default_rng(0)
    x = rs.standard_normal(500) * 30
    np.testing.assert_array_equal(tranking.stable_sigmoid(x), jranking.stable_sigmoid(x))
    labels = rs.random(500) < 0.4
    scores = np.round(rs.random(500), 2)  # ties
    assert tranking.roc_auc(labels, scores) == jranking.roc_auc(labels, scores)
    assert tranking.roc_auc(np.ones(4), scores[:4]) == 0.0


def _imported_modules(path):
    """(module, inside a ``try`` body) of every absolute import in ``path``."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    in_try = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Try):
            for stmt in node.body:
                in_try.update(id(n) for n in ast.walk(stmt))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from ((a.name, id(node) in in_try) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module, id(node) in in_try


def test_port_sources_import_no_jax_and_no_pmgt_tpu():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "pmgt_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for new in ("cli/main.py", "cli/data_cmds.py", "train/engine.py",
                "train/checkpoints.py", "train/registry.py", "cli/hpo.py",
                "cli/space_yaml.py", "data/preprocess.py", "data/ingest.py",
                "native/__init__.py", "core/mesh.py", "data/feature_extraction.py",
                "utils/base.py", "tools/__init__.py", "tools/scale_smoke.py",
                "tools/validate_pipeline.py", "tools/quality_int8_tables.py",
                "tools/reproduce_published.py"):
        assert os.path.join(ROOT, "pmgt_tpu_torch", new) in files
    bad, tried = [], set()
    for p in files:
        rel = os.path.relpath(p, ROOT)
        for m, in_try in _imported_modules(p):
            top = m.split(".")[0]
            if top not in FORBIDDEN:
                continue
            if in_try and (rel, top) in TRY_ONLY:
                tried.add((rel, top))
            else:
                bad.append((rel, m))
    assert not bad, bad
    assert tried == TRY_ONLY  # the optional import is where it belongs


def test_port_imports_with_jax_unavailable():
    code = (
        "import sys\n"
        f"for m in {FORBIDDEN!r}: sys.modules[m] = None\n"
        "import pmgt_tpu_torch, pkgutil, importlib\n"
        "for m in pkgutil.walk_packages(pmgt_tpu_torch.__path__, 'pmgt_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r} and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
