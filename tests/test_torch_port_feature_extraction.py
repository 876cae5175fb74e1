"""The port's feature extractors (``pmgt_tpu_torch/data/feature_extraction.py``)
and ``run_preprocess(extract_features=True)`` against the JAX package's, on
the CPU, with the stand-ins of ``tests/test_ingest.py``: a stub CNN with
timm's ``forward_features`` / ``global_pool`` surface and a tiny randomly
initialised BERT with its WordPiece tokenizer saved locally.

- Visual and textual rows equal the JAX rows within 1e-6 (more than 16
  reviews an item: two tokenizer batches; empty reviews left out).
- With ``extract_features=True`` the whole artifact set equals the JAX
  package's: feature tables within 1e-6, everything else bit-equal; the
  ``<dataset>_{visual,textual}_feats.npz`` files are written.
- Without timm, or without PIL, the visual modality falls back to random
  rows at the requested width while the textual one is extracted, as in
  JAX; a missing text model falls back the same way.
- A model whose forward raises, and a device that does not exist, raise:
  the port does not fall back where the JAX package swallows everything.
- ``.part`` and unreadable files are skipped; the drop-in ``.npz`` still
  wins over the extractors; the command line's ``--feature-device``
  follows ``--device``.
- ``graph.from_networkx`` (both node offsets, the non-contiguous error,
  a duck-typed graph) and ``utils.set_seed`` against the JAX package's.
"""
from __future__ import annotations

import json
import os
import random
import sys

import numpy as np
import pytest
import torch

from pmgt_tpu.data import feature_extraction as jfx
from pmgt_tpu.data import preprocess as jpre
from pmgt_tpu.graph import container as jcontainer
from pmgt_tpu.utils import base as jbase
from pmgt_tpu_torch.cli.main import main
from pmgt_tpu_torch.data import feature_extraction as tfx
from pmgt_tpu_torch.data import preprocess as tpre
from pmgt_tpu_torch.graph import container as tcontainer
from pmgt_tpu_torch.utils import set_seed

pytest.importorskip("PIL")
pytest.importorskip("transformers")

FILES = ("graph.npz", "init_embs.npz", "interactions.npz", "classes.npz")


class StubCNN(torch.nn.Module):
    """The stand-in of tests/test_ingest.py: timm's surface, 8 wide."""

    def __init__(self, dim=8):
        super().__init__()
        torch.manual_seed(0)
        self.conv = torch.nn.Conv2d(3, dim, kernel_size=5, stride=7)

    def forward_features(self, x):
        return self.conv(x)

    def global_pool(self, x):
        return x.mean(dim=(2, 3))


class Broken(StubCNN):
    def forward_features(self, x):
        raise RuntimeError("forward failed")


@pytest.fixture(scope="module")
def tiny_bert_dir(tmp_path_factory):
    """A randomly initialised 1-layer BERT and its WordPiece tokenizer,
    saved locally (tests/test_ingest.py's)."""
    from transformers import BertConfig, BertModel, BertTokenizer

    d = tmp_path_factory.mktemp("tiny_bert_port")
    torch.manual_seed(0)
    cfg = BertConfig(vocab_size=32, hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
                     intermediate_size=32, max_position_embeddings=64)
    BertModel(cfg).save_pretrained(d)
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
             "great", "game", "bad", "toy", "fun", "the", "a"]
    (d / "vocab.txt").write_text("\n".join(vocab))
    BertTokenizer(str(d / "vocab.txt")).save_pretrained(d)
    return str(d)


def _toy_raw_dir(root):
    """tests/test_ingest.py's toy dump: A, B, C co-reviewed by three users
    before the split (a triangle), two users after; images for A and B."""
    from PIL import Image

    raw = root / "raw"
    raw.mkdir()
    pre_t, post_t = 1_000_000, 2_000_000_000
    reviews = []
    for u in ("u1", "u2", "u3"):
        for a in ("A", "B", "C"):
            text = "great fun game" if a in ("A", "B") else "bad toy"
            reviews.append({"reviewerID": u, "asin": a, "unixReviewTime": pre_t,
                            "reviewText": text})
    for u in ("u4", "u5"):
        for a in ("A", "B", "C"):
            reviews.append({"reviewerID": u, "asin": a, "unixReviewTime": post_t})
    (raw / "reviews.json").write_text("\n".join(json.dumps(r) for r in reviews))
    img_dir = raw / "images"
    for asin, color in (("A", (255, 0, 0)), ("B", (0, 0, 255))):
        (img_dir / asin).mkdir(parents=True)
        Image.new("RGB", (32, 32), color).save(img_dir / asin / "0.png")
    return raw


def _both(tmp_path, raw, **kw):
    """``run_preprocess`` of both packages (the port on the CPU) into
    separate directories."""
    kw = {"dataset_name": "toy", "min_common_users": 3, "seed": 0, **kw}
    ja = jpre.run_preprocess(raw_dir=str(raw), out_dir=str(tmp_path / "jax"), **kw)
    ta = tpre.run_preprocess(raw_dir=str(raw), out_dir=str(tmp_path / "torch"),
                             feature_device="cpu", **kw)
    return ja, ta


def _assert_same_artifacts(dj, dt):
    """Feature tables within 1e-6, every other array and meta.json equal."""
    for name in FILES:
        with np.load(os.path.join(dj, name), allow_pickle=False) as zj, \
                np.load(os.path.join(dt, name), allow_pickle=False) as zt:
            assert sorted(zj.files) == sorted(zt.files), name
            for key in zj.files:
                a, b = zj[key], zt[key]
                assert a.dtype == b.dtype and a.shape == b.shape, (name, key)
                if name == "init_embs.npz":
                    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6, err_msg=key)
                else:
                    np.testing.assert_array_equal(b, a, err_msg=f"{name}:{key}")
    with open(os.path.join(dj, "meta.json")) as f, open(os.path.join(dt, "meta.json")) as g:
        assert json.load(f) == json.load(g)


@pytest.fixture
def no_timm(monkeypatch):
    monkeypatch.setitem(sys.modules, "timm", None)  # import timm raises ImportError


def test_visual_rows_equal_jax(tmp_path):
    raw = _toy_raw_dir(tmp_path)
    images = str(raw / "images")
    got = tfx.extract_visual_features(tfx.iter_item_images(images), model=StubCNN(),
                                      transform=tfx.default_image_transform(32), device="cpu")
    want = jfx.extract_visual_features(jfx.iter_item_images(images), model=StubCNN(),
                                       transform=jfx.default_image_transform(32))
    assert got[1] == want[1] == ["A", "B"]
    assert got[0].dtype == np.float32 and got[0].shape == (2, 8)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    empty = tfx.extract_visual_features(iter(()), model=StubCNN(), device="cpu")
    assert empty[0].shape == (0, 0) and empty[1] == []


def test_textual_rows_equal_jax(tiny_bert_dir):
    texts = {"A": ["great fun game"] * 9 + ["bad toy the a game"] * 9 + [""],
             "B": ["the toy", "", "fun"], "C": ["", ""], "D": ["a " * 200]}
    got = tfx.extract_textual_features(texts, model_name=tiny_bert_dir, device="cpu",
                                       max_length=32)  # the tiny BERT has 64 positions
    want = jfx.extract_textual_features(texts, model_name=tiny_bert_dir, max_length=32)
    assert got[1] == want[1] == ["A", "B", "D"]  # C has no non-empty review
    assert got[0].dtype == np.float32 and got[0].shape == (3, 16)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    # an injected model and tokenizer give the same rows
    model, tok = tfx.load_text_model(tiny_bert_dir)
    again = tfx.extract_textual_features(texts, model=model, tokenizer=tok, device="cpu",
                                         max_length=32)
    np.testing.assert_array_equal(again[0], got[0])


def test_extract_features_artifacts_equal_jax(tmp_path, tiny_bert_dir):
    raw = _toy_raw_dir(tmp_path)
    ja, ta = _both(tmp_path, raw, extract_features=True, text_model=tiny_bert_dir,
                   visual_model=StubCNN(), visual_transform=tfx.default_image_transform(32))
    _assert_same_artifacts(str(tmp_path / "jax" / "toy"), str(tmp_path / "torch" / "toy"))
    visual, textual = ta.feat_init_embs
    assert visual.shape == (5, 8) and textual.shape == (5, 16)
    for modality, table in (("visual", visual), ("textual", textual)):
        with np.load(tmp_path / "torch" / f"toy_{modality}_feats.npz", allow_pickle=True) as z:
            nodes = list(ta.node_classes)
            for asin, row in zip(z["asins"].tolist(), z["feats"]):
                np.testing.assert_array_equal(table[2 + nodes.index(asin)], row)


@pytest.mark.parametrize("missing", ["timm", "PIL"])
def test_visual_falls_back_without_its_package(tmp_path, tiny_bert_dir, monkeypatch, caplog,
                                               missing):
    raw = _toy_raw_dir(tmp_path)
    monkeypatch.setitem(sys.modules, "timm", None)
    kw = {"visual_model": StubCNN()} if missing == "PIL" else {}
    if missing == "PIL":
        monkeypatch.setitem(sys.modules, "PIL", None)
    ja, ta = _both(tmp_path, raw, extract_features=True, text_model=tiny_bert_dir,
                   visual_dim=24, **kw)
    _assert_same_artifacts(str(tmp_path / "jax" / "toy"), str(tmp_path / "torch" / "toy"))
    visual, textual = ta.feat_init_embs
    assert visual.shape[1] == 24 and textual.shape[1] == 16  # fallback; extracted
    assert not (tmp_path / "torch" / "toy_visual_feats.npz").exists()
    assert any(r.getMessage().startswith("visual extraction unavailable")
               for r in caplog.records)


@pytest.mark.parametrize("missing", ["transformers", "model_dir"])
def test_missing_text_model_falls_back(tmp_path, no_timm, monkeypatch, missing):
    """Without transformers, or with no model at the path, the textual
    table falls back to the JAX package's random rows (the JAX side runs
    without transformers: it would try to download a name it cannot
    find)."""
    raw = _toy_raw_dir(tmp_path)
    kw = dict(dataset_name="toy", min_common_users=3, extract_features=True,
              visual_model=StubCNN(), visual_transform=tfx.default_image_transform(32),
              textual_dim=6, text_model=str(tmp_path / "no_model"))
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "transformers", None)
        jpre.run_preprocess(raw_dir=str(raw), out_dir=str(tmp_path / "jax"), **kw)
        if missing == "transformers":
            ta = tpre.run_preprocess(str(raw), str(tmp_path / "torch"), feature_device="cpu",
                                     **kw)
    if missing == "model_dir":
        ta = tpre.run_preprocess(str(raw), str(tmp_path / "torch"), feature_device="cpu", **kw)
    _assert_same_artifacts(str(tmp_path / "jax" / "toy"), str(tmp_path / "torch" / "toy"))
    assert ta.feat_init_embs[1].shape[1] == 6


@pytest.mark.parametrize("fault", ["visual_forward", "text_forward", "device"])
def test_a_model_or_device_fault_raises(tmp_path, tiny_bert_dir, monkeypatch, fault):
    """The JAX package falls back to random rows on any error; the port
    raises."""
    raw = _toy_raw_dir(tmp_path)
    kw = dict(raw_dir=str(raw), out_dir=str(tmp_path / "o"), dataset_name="toy",
              min_common_users=3, extract_features=True, text_model=tiny_bert_dir,
              visual_model=StubCNN(), visual_transform=tfx.default_image_transform(32),
              feature_device="cpu")
    if fault == "visual_forward":
        kw["visual_model"] = Broken()
    elif fault == "text_forward":
        from transformers import BertModel

        def broken(self, *a, **k):
            raise RuntimeError("forward failed")

        monkeypatch.setattr(BertModel, "forward", broken)
    else:
        kw["feature_device"] = "cuda:99"
    with pytest.raises((RuntimeError, AssertionError)):
        tpre.run_preprocess(**kw)
    if fault != "device":  # the JAX package swallows it
        jkw = {k: v for k, v in kw.items() if k != "feature_device"}
        art = jpre.run_preprocess(**{**jkw, "out_dir": str(tmp_path / "j")})
        assert art.num_nodes == 3


def test_part_and_unreadable_files_are_skipped(tmp_path, caplog):
    from PIL import Image

    raw = _toy_raw_dir(tmp_path)
    item = raw / "images" / "A"
    Image.new("RGB", (32, 32), (0, 255, 0)).save(item / "1.png")
    Image.new("RGB", (32, 32), (9, 9, 9)).save(item / "2.png.part", format="PNG")
    (item / "3.jpg").write_bytes(b"not an image")
    (raw / "images" / "E").mkdir()
    (raw / "images" / "E" / "0.jpg").write_bytes(b"\x89PNG broken")
    got = [(a, [np.asarray(i) for i in imgs])
           for a, imgs in tfx.iter_item_images(str(raw / "images"))]
    want = [(a, [np.asarray(i) for i in imgs])
            for a, imgs in jfx.iter_item_images(str(raw / "images"))]
    assert [a for a, _ in got] == [a for a, _ in want] == ["A", "B"]
    assert [len(i) for _, i in got] == [2, 1]
    for (_, g), (_, w) in zip(got, want):
        for x, y in zip(g, w):
            np.testing.assert_array_equal(x, y)
    assert sum("skipping unreadable image" in r.getMessage() for r in caplog.records) >= 2
    assert list(tfx.iter_item_images(str(tmp_path / "absent"))) == []


def test_drop_in_npz_still_wins(tmp_path, tiny_bert_dir):
    raw = _toy_raw_dir(tmp_path)
    out = tmp_path / "torch"
    out.mkdir()
    rng = np.random.default_rng(3)
    dropped = {}
    for modality, dim, asins in (("visual", 5, ["A", "C"]), ("textual", 3, ["B"])):
        dropped[modality] = (asins, rng.normal(size=(len(asins), dim)).astype(np.float32))
        tfx.save_feats_npz(str(out / f"toy_{modality}_feats.npz"), dropped[modality][1], asins)
    art = tpre.run_preprocess(str(raw), str(out), "toy", min_common_users=3,
                              extract_features=True, text_model=str(tmp_path / "none"),
                              visual_model=Broken(), feature_device="cpu")
    nodes = list(art.node_classes)
    for table, (asins, feats) in zip(art.feat_init_embs, dropped.values()):
        assert table.shape[1] == feats.shape[1]
        for asin, row in zip(asins, feats):
            np.testing.assert_array_equal(table[2 + nodes.index(asin)], row)


def test_command_line_extracts_on_its_device(tmp_path, tiny_bert_dir, no_timm):
    raw = _toy_raw_dir(tmp_path)
    art = main(["--device", "cpu", "preprocess", "--raw-dir", str(raw), "--out-dir",
                str(tmp_path / "cli"), "--dataset-name", "toy", "--min-common-users", "3",
                "--extract-features", "--text-model", tiny_bert_dir])
    ref = tpre.run_preprocess(str(raw), str(tmp_path / "ref"), "toy", min_common_users=3,
                              extract_features=True, text_model=tiny_bert_dir,
                              feature_device="cpu")
    for a, b in zip(art.feat_init_embs, ref.feat_init_embs):
        np.testing.assert_array_equal(a, b)
    assert art.feat_init_embs[1].shape[1] == 16 and art.feat_init_embs[0].shape[1] == 1536


class DuckGraph:
    """A networkx-like graph without networkx."""

    def __init__(self, nodes, edges):
        self._nodes, self._edges = nodes, edges

    def nodes(self):
        return list(self._nodes)

    def edges(self, data=False):
        return [(u, v, dict(d)) for u, v, d in self._edges]


@pytest.mark.parametrize("offset", [0, 2])
def test_from_networkx_matches_jax_and_from_edges(offset):
    nx = pytest.importorskip("networkx")
    rng = np.random.default_rng(offset)
    g = nx.Graph()
    g.add_nodes_from(range(offset, offset + 12))
    for _ in range(30):
        u, v = (int(x) + offset for x in rng.integers(0, 12, 2))
        if u != v:
            g.add_edge(u, v, weight=float(rng.random()))
    g.add_edge(offset, offset + 11)  # no weight: 1.0
    got = tcontainer.from_networkx(g)
    want = jcontainer.from_networkx(g)
    edges = [(u - offset, v - offset, d.get("weight", 1.0)) for u, v, d in g.edges(data=True)]
    plain = tcontainer.from_edges(12, edges)
    duck = tcontainer.from_networkx(DuckGraph(g.nodes(), g.edges(data=True)), max_degree=3)
    assert duck.max_degree <= 3
    for name in ("nbr_ids", "nbr_logits", "degrees", "alias_prob", "alias_idx"):
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)), name)
        np.testing.assert_array_equal(getattr(got, name), getattr(plain, name), name)


def test_from_networkx_refuses_a_non_contiguous_range():
    g = DuckGraph([0, 1, 3], [(0, 1, {}), (1, 3, {"weight": 2.0})])
    for pkg in (tcontainer, jcontainer):
        with pytest.raises(ValueError, match="contiguous"):
            pkg.from_networkx(g)


def test_set_seed_matches_jax():
    draws = []
    for seed_fn in (set_seed, jbase.set_seed):
        seed_fn(7)
        draws.append((random.random(), np.random.rand(3).tolist()))
    assert draws[0] == draws[1]
