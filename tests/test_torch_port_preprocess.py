"""The port's offline preprocessing (``pmgt_tpu_torch/data/preprocess.py``)
against the JAX package's (``pmgt_tpu/data/preprocess.py``).

``run_preprocess`` of both packages, into separate directories, on the
miniature raw dump of ``tests/fixtures/ref_mini/raw`` and on a generated
dump of a few thousand reviews (communities of items, skewed activity,
malformed lines, repeated reviews): every array the native artifacts hold
is equal bit for bit (the graph with its alias tables, both feature
tables, ``train_pairs``, ``test_pairs``, ``classes.npz``), and so is
``meta.json``. The same with seeded ``<dataset>_{visual,textual}_
feats.npz`` under ``extract_features=True``; without them the port's
modalities keep the random rows (the JAX extractors' fallback, which needs
no weights to reach). Also the guards, the weight formula, the reader and
the ``preprocess`` command.
"""
import gzip
import json
import logging
import os

import numpy as np
import pytest

from pmgt_tpu.data import preprocess as jpre
from pmgt_tpu_torch.cli.main import main
from pmgt_tpu_torch.data import preprocess as tpre
from pmgt_tpu_torch.data.artifacts import load_artifacts

FIXTURE_RAW = os.path.join(os.path.dirname(__file__), "fixtures", "ref_mini", "raw")
FILES = ("graph.npz", "init_embs.npz", "interactions.npz", "classes.npz")


def _write_dump(raw_dir, n_reviews=3000, seed=0):
    """A gzipped review dump: items in communities of 8, each reviewer
    mostly inside one community, timestamps around 2015-01-01; a few
    malformed lines and reviews without an item."""
    rng = np.random.default_rng(seed)
    os.makedirs(raw_dir, exist_ok=True)
    n_items, n_users = 160, 400
    home = rng.integers(0, n_items // 8, n_users)
    lines = []
    for _ in range(n_reviews):
        u = int(n_users * rng.random() ** 2)  # skewed activity
        item = (home[u] * 8 + rng.integers(0, 8)) if rng.random() < 0.85 \
            else rng.integers(0, n_items)
        t = 1_420_070_400 + int(rng.normal(0, 3e7))  # 2015-01-01 ± ~1 year
        lines.append(json.dumps({"reviewerID": f"U{u:04d}", "asin": f"B{int(item):05d}",
                                 "unixReviewTime": t, "reviewText": "fun toy",
                                 "overall": float(rng.integers(1, 6))}))
    lines[5] = "{not json"
    lines[9] = json.dumps({"reviewerID": "U0001"})
    lines.insert(20, "")
    with gzip.open(os.path.join(raw_dir, "reviews.json.gz"), "wt") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(raw_dir, "meta_Toys.json"), "w") as f:
        f.write("{}\n")  # a metadata dump: never read as reviews
    return raw_dir


def _assert_same_artifacts(dj, dt):
    for name in FILES:
        with np.load(os.path.join(dj, name), allow_pickle=False) as zj, \
                np.load(os.path.join(dt, name), allow_pickle=False) as zt:
            assert sorted(zj.files) == sorted(zt.files), name
            for key in zj.files:
                a, b = zj[key], zt[key]
                assert a.dtype == b.dtype and a.shape == b.shape, (name, key)
                np.testing.assert_array_equal(a, b, err_msg=f"{name}:{key}")
    with open(os.path.join(dj, "meta.json")) as f, open(os.path.join(dt, "meta.json")) as g:
        assert json.load(f) == json.load(g)


def _run_both(tmp_path, raw_dir, **kw):
    kw = {"dataset_name": "D", "visual_dim": 12, "textual_dim": 6, **kw}
    ja = jpre.run_preprocess(raw_dir=raw_dir, out_dir=str(tmp_path / "jax"), **kw)
    ta = tpre.run_preprocess(raw_dir=raw_dir, out_dir=str(tmp_path / "torch"), **kw)
    _assert_same_artifacts(str(tmp_path / "jax" / "D"), str(tmp_path / "torch" / "D"))
    return ja, ta


@pytest.mark.parametrize("min_common,test_size,seed", [(2, 0.2, 0), (1, 0.5, 3), (2, 0.0, 1)])
def test_fixture_dump_artifacts_bit_equal(tmp_path, min_common, test_size, seed):
    ja, ta = _run_both(tmp_path, FIXTURE_RAW, min_common_users=min_common,
                       test_size=test_size, seed=seed)
    assert ta.num_nodes == ja.num_nodes > 0
    assert len(ta.test_pairs) == (0 if test_size == 0 else len(ja.test_pairs))


@pytest.mark.parametrize("split_date", ["2015-01-01", "2014-06-01"])
def test_generated_dump_artifacts_bit_equal(tmp_path, split_date):
    raw = _write_dump(str(tmp_path / "raw"), seed=11)
    ja, ta = _run_both(tmp_path, raw, min_common_users=3, split_date=split_date, seed=5)
    assert ta.num_nodes > 20 and len(ta.train_pairs) > 100
    assert int(ta.graph.degrees.sum()) == int(ja.graph.degrees.sum())
    # the port reads its own output back
    back = load_artifacts(str(tmp_path / "torch"), "D")
    np.testing.assert_array_equal(back.train_pairs, ta.train_pairs)
    assert list(back.node_classes) == list(ta.node_classes)


def test_seeded_feature_files_fill_the_same_rows(tmp_path):
    raw = _write_dump(str(tmp_path / "raw"), seed=2)
    base = tpre.run_preprocess(raw, str(tmp_path / "probe"), "D", visual_dim=12, textual_dim=6)
    items = [str(a) for a in base.node_classes]
    rng = np.random.default_rng(9)
    seeded = {}
    for out in ("jax", "torch"):
        os.makedirs(tmp_path / out, exist_ok=True)
        for modality, dim, picked in (("visual", 10, items[::2] + ["NOT_AN_ITEM"]),
                                      ("textual", 5, items[1::3])):
            feats = seeded.setdefault(modality, rng.normal(size=(len(picked), dim)))
            np.savez_compressed(tmp_path / out / f"D_{modality}_feats.npz",
                                feats=feats.astype(np.float32),
                                asins=np.asarray(picked, dtype=object))
    ja, ta = _run_both(tmp_path, raw, extract_features=True)
    visual = ta.feat_init_embs[0]
    assert visual.shape == (len(items) + 2, 10)
    np.testing.assert_array_equal(visual[2::2][: len(items[::2])],
                                  seeded["visual"][:-1].astype(np.float32))
    assert ta.feat_init_embs[1].shape == (len(items) + 2, 5)


def test_unseeded_extraction_keeps_the_random_rows(tmp_path, caplog):
    raw = _write_dump(str(tmp_path / "raw"), seed=4)
    plain = tpre.run_preprocess(raw, str(tmp_path / "a"), "D", visual_dim=12, textual_dim=6)
    with caplog.at_level(logging.WARNING, logger="pmgt_tpu_torch"):
        art = tpre.run_preprocess(raw, str(tmp_path / "b"), "D", visual_dim=12,
                                  textual_dim=6, extract_features=True)
    for a, b in zip(plain.feat_init_embs, art.feat_init_embs):
        np.testing.assert_array_equal(a, b)
    msgs = [r.getMessage() for r in caplog.records if r.levelno == logging.WARNING]
    assert any(m.startswith("visual extraction unavailable") and "12-d" in m for m in msgs)
    assert any(m.startswith("textual extraction unavailable") and "6-d" in m for m in msgs)


@pytest.mark.parametrize("test_size", [1.0, 20, -0.1])
def test_test_size_guard(tmp_path, test_size):
    for pkg in (jpre, tpre):
        with pytest.raises(ValueError, match="test_size"):
            pkg.run_preprocess(FIXTURE_RAW, str(tmp_path), "D", test_size=test_size)


def test_empty_graph_and_missing_dump_errors(tmp_path):
    for pkg in (jpre, tpre):
        with pytest.raises(ValueError, match="empty co-review graph"):
            pkg.run_preprocess(FIXTURE_RAW, str(tmp_path), "D", min_common_users=1000)
        with pytest.raises(FileNotFoundError):
            pkg.run_preprocess(str(tmp_path / "none"), str(tmp_path), "D")


def test_reviews_reader_equals_the_jax_reader(tmp_path):
    raw = _write_dump(str(tmp_path / "raw"), n_reviews=500, seed=6)
    for keep_text in (False, True):
        assert tpre._load_reviews(raw, keep_text) == jpre._load_reviews(raw, keep_text)
    assert tpre._find_review_dumps(raw) == jpre._find_review_dumps(raw)
    assert tpre._split_timestamp("2015-01-01") == jpre._split_timestamp("2015-01-01")


def test_weight_formula():
    """Edge weights follow (log w + 1)/(log sqrt(deg_u deg_v) + 1), as in
    ``tests/test_data.py``, and the port's graph equals the JAX one."""
    reviews = []
    for u in range(3):
        reviews += [{"reviewerID": f"u{u}", "asin": a} for a in "ABC"]
    reviews += [{"reviewerID": "u9", "asin": "B"}, {"reviewerID": "u9", "asin": "C"}]
    node_items, edges = tpre.build_co_review_graph(reviews, min_common_users=3)
    j_items, j_edges = jpre.build_co_review_graph(reviews, min_common_users=3)
    assert node_items.tolist() == j_items.tolist() == ["A", "B", "C"]
    assert edges == j_edges
    w = {(min(u, v), max(u, v)): wt for u, v, wt in edges}
    assert w[(0, 1)] == pytest.approx((np.log(3) + 1) / (np.log(np.sqrt(4)) + 1))
    assert w[(1, 2)] == pytest.approx((np.log(4) + 1) / (np.log(np.sqrt(4)) + 1))


def test_scipy_counter_takes_over_above_the_cap(tmp_path, monkeypatch):
    """Above the native counter's memory cap the scipy product builds the
    same graph."""
    raw = _write_dump(str(tmp_path / "raw"), n_reviews=1500, seed=8)
    pairs = {(u, a) for u, a, t, _ in tpre._load_reviews(raw)
             if t < tpre._split_timestamp("2015-01-01")}
    want = tpre._graph_from_pairs(pairs, 2)
    from pmgt_tpu_torch import native

    real = native.co_review_edges_native
    monkeypatch.setattr(native, "co_review_edges_native",
                        lambda i, u, m: real(i, u, m, max_pairs=0))
    got = tpre._graph_from_pairs(pairs, 2)
    assert got[0].tolist() == want[0].tolist() and got[1] == want[1]


def test_preprocess_command_writes_the_same_artifacts(tmp_path):
    raw = _write_dump(str(tmp_path / "raw"), seed=12)
    kw = dict(dataset_name="D", min_common_users=2, test_size=0.3, seed=2,
              visual_dim=1536, textual_dim=768)
    jpre.run_preprocess(raw_dir=raw, out_dir=str(tmp_path / "jax"), **kw)
    art = main(["--device", "cpu", "preprocess", "--raw-dir", raw, "--out-dir",
                str(tmp_path / "torch"), "--dataset-name", "D", "--min-common-users", "2",
                "--test-size", "0.3", "--seed", "2"])
    assert art.feat_init_embs[0].shape[1] == 1536
    _assert_same_artifacts(str(tmp_path / "jax" / "D"), str(tmp_path / "torch" / "D"))
