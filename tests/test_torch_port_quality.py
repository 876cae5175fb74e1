"""The port's quality tools against the JAX package's (CPU, small sizes).

- ``tools/validate_pipeline``: every family end to end (``pmgt_ncf`` and
  ``--no-ctx-cache`` included); ``results.json`` has the JAX tool's keys
  and metric names and finite values; each stage's ``TrainArgs`` is the
  JAX tool's, transcribed with its ``file:line``; ``compare_to_jax`` at
  each bound and just past it.
- ``tools/quality_int8_tables``: both table dtypes train and agree within
  the tool's bound; the ``TrainArgs`` are the JAX tool's.
- ``tools/reproduce_published``: the fixture chain (every stage ``ok``, the
  export shaped as the reference's, finite metrics), real mode with the
  download failing (``blocked``), and ``TARGETS``, ``PRIMARY``,
  ``TOLERANCE`` and ``stage_compare``'s verdicts against the JAX tool's.
- The published-shape datasets equal the JAX package's bit for bit: the
  quality comparison rests on both packages seeing the same data.
- The reference-format loader needs neither pickle's packages nor pandas
  (the card machine has none of them) and refuses foreign classes.

The module trains on one thread: beside the suite's other workers, torch's
default of a thread a core makes these runs tens of times slower.
"""
from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
from sklearn.model_selection import train_test_split

from pmgt_tpu.core.config import TrainArgs as JTrainArgs
from pmgt_tpu.data import interactions as jinteractions
from pmgt_tpu.data import synthetic as jsynthetic
from pmgt_tpu_torch.data import artifacts as tartifacts
from pmgt_tpu_torch.data import interactions as tinteractions
from pmgt_tpu_torch.data import synthetic as tsynthetic
from pmgt_tpu_torch.tasks import pmgt_task as tpmgt_task
from pmgt_tpu_torch.tools import quality_int8_tables as q8
from pmgt_tpu_torch.tools import reproduce_published as trp
from pmgt_tpu_torch.tools import validate_pipeline as vp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "ref_mini")
NCF_METRICS = {"test/loss", "test/n10", "test/r10", "test/n20", "test/r20"}
KEYS = {"provenance": None, "pmgt": {"val/auc", "val/loss", "best"},
        **{k: NCF_METRICS for k in ("ncf_plain", "ncf_pmgt", "gmf", "mlp", "neumf_pre",
                                    "pmgt_ncf")},
        "dcn_plain": {"test/auc", "test/loss"}, "dcn_pmgt": {"test/auc", "test/loss"}}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("quality"))
    argv = ["--num-nodes", "200", "--num-users", "150", "--pmgt-epochs", "1",
            "--downstream-epochs", "1", "--device", "cpu", "--no-ctx-cache", "--out", out,
            "--families", "neumf,dcn,gmf,mlp,neumf_pre,pmgt_ncf"]
    assert vp.main(argv) == 0
    with open(os.path.join(out, "results.json")) as f:
        return json.load(f), out


def test_validate_pipeline_writes_the_jax_tools_keys(pipeline):
    results, out = pipeline
    assert set(results) == set(KEYS)
    for stage, names in KEYS.items():
        if names is not None:
            assert set(results[stage]) == names, stage
            assert all(np.isfinite(v) for v in results[stage].values()), (stage, results[stage])
    # the JAX package's records use the same metric names
    with open(os.path.join(REPO, "QUALITY_VG.json")) as f:
        jax = json.load(f)
    for stage in set(jax) - {"provenance", "signal"}:
        assert set(jax[stage]) == set(results[stage]), stage
    prov = results["provenance"]
    assert set(prov) >= {"commit", "argv", "card"} and "--no-ctx-cache" in prov["argv"]
    assert prov["card"] is None  # no card here
    emb = np.load(os.path.join(out, "node_feat_128dim.npy"))
    assert emb.shape == (200, 128) and np.isfinite(emb).all()


def _ns(**over):
    ns = vp.parse(["--out", "OUT"])
    for k, v in over.items():
        setattr(ns, k, v)
    return ns


# The JAX tool's arguments, transcribed (it parses its flags at import, so
# it cannot be imported): tools/validate_pipeline.py.
JAX_BASE_NCF = dict(factor_num=64, num_layers=2, num_ng=1, max_sample_items=500)  # :155


def _jax_pmgt(epochs, ctx_cache):  # :124-141
    return JTrainArgs(
        model_name="PMGT", dataset_name="Q", seed=0, num_epochs=epochs,
        train_batch_size=256, test_batch_size=512, lr=1e-4, decay=1e-2,
        early=5, early_criterion="auc", valid_size=0.1, mp_enabled=True,
        gradient_max_norm=5.0, ckpt_interval=1_000_000, log_dir="OUT/logs",
        extra=dict(hidden_size=128, intermediate_size=128, num_hidden_layers=5,
                   ctx_cache=ctx_cache))


def _jax_ncf(model_name, extra, seed, epochs, lr=1e-3):  # :157-164 (run_ncf)
    return JTrainArgs(
        model_name=model_name, dataset_name="Q", seed=seed, num_epochs=epochs,
        train_batch_size=256, test_batch_size=512, lr=lr, decay=0.0,
        early=4, early_criterion="n20", valid_size=0.2, mp_enabled=True,
        gradient_max_norm=5.0, ckpt_interval=1_000_000, log_dir="OUT/logs", extra=dict(extra))


def _jax_pmgt_ncf(seed, epochs):  # :219-231
    return JTrainArgs(
        model_name="NeuMF-end", dataset_name="Q", seed=seed, num_epochs=epochs,
        train_batch_size=256, test_batch_size=512, lr=1e-3, decay=0.0,
        early=4, early_criterion="n20", valid_size=0.2, mp_enabled=True,
        gradient_max_norm=5.0, ckpt_interval=1_000_000, log_dir="OUT/logs",
        extra=dict(factor_num=64, num_layers=2, num_ng=1, max_sample_items=500,
                   hidden_size=128, intermediate_size=128, num_hidden_layers=5))


def _jax_dcn(emb, seed, epochs):  # :244-259
    extra = dict(factor_num=32, deep_net_num_layers=2, cross_net_num_layers=3,
                 num_ng=1, max_sample_items=5, emb_dropout=0.2, use_layer_norm=True)
    if emb:
        extra.update(item_init_emb_path=emb, normalize_item_init_emb=True)
    return JTrainArgs(
        model_name="DCN", dataset_name="Q", seed=seed, num_epochs=epochs,
        train_batch_size=256, test_batch_size=512, lr=1e-3, decay=1e-3,
        early=4, early_criterion="auc", valid_size=0.2, mp_enabled=True,
        gradient_max_norm=5.0, ckpt_interval=1_000_000, log_dir="OUT/logs", extra=extra)


EMB = "E.npy"
STAGES = {
    "pmgt": (lambda ns: vp.pmgt_args(ns), lambda: _jax_pmgt(8, True)),
    "pmgt_no_ctx_cache": (lambda ns: vp.pmgt_args(_ns(no_ctx_cache=True)),
                          lambda: _jax_pmgt(8, False)),
    "ncf_plain": (lambda ns: vp.ncf_args(ns, "NeuMF-end", vp.with_export(vp.BASE_NCF, None)),
                  lambda: _jax_ncf("NeuMF-end", JAX_BASE_NCF, 3, 12)),
    "ncf_pmgt": (lambda ns: vp.ncf_args(ns, "NeuMF-end", vp.with_export(vp.BASE_NCF, EMB)),
                 lambda: _jax_ncf("NeuMF-end", dict(JAX_BASE_NCF, item_init_emb_path=EMB,  # :183-185
                                                    normalize_item_init_emb=True), 3, 12)),
    "gmf": (lambda ns: vp.ncf_args(ns, "GMF", vp.BASE_NCF),
            lambda: _jax_ncf("GMF", JAX_BASE_NCF, 3, 12)),  # :189
    "mlp": (lambda ns: vp.ncf_args(ns, "MLP", vp.BASE_NCF),
            lambda: _jax_ncf("MLP", JAX_BASE_NCF, 3, 12)),  # :191
    "neumf_pre": (lambda ns: vp.neumf_pre_args(ns, "G", "M"),
                  lambda: _jax_ncf("NeuMF-pre", dict(JAX_BASE_NCF, gmf_run_id="G",  # :202-214
                                                     mlp_run_id="M", alpha=0.5, eval_init=True),
                                   3, 12, lr=1e-4)),
    "pmgt_ncf": (lambda ns: vp.pmgt_ncf_args(ns), lambda: _jax_pmgt_ncf(3, 12)),
    "dcn_plain": (lambda ns: vp.dcn_args(ns, None), lambda: _jax_dcn(None, 3, 12)),
    "dcn_pmgt": (lambda ns: vp.dcn_args(ns, EMB), lambda: _jax_dcn(EMB, 3, 12)),
}


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_stage_args_equal_the_jax_tools(stage):
    port, jax = STAGES[stage]
    assert port(_ns(downstream_seed=3)).to_dict() == jax().to_dict()


def test_flags_and_defaults_equal_the_jax_tools():
    ns = vp.parse([])
    assert (ns.pmgt_epochs, ns.downstream_epochs, ns.no_ctx_cache, ns.families, ns.num_nodes,
            ns.num_users, ns.shape, ns.signal, ns.emb_path, ns.downstream_seed) == (
        8, 12, False, "neumf,dcn,gmf,mlp,neumf_pre", 6500, 5000, None, None, None, 0)
    assert ns.device == "cuda"


# ---------------------------------------------------------------- comparison
JAX = {"ncf_plain": {"test/n20": 0.20, "test/r20": 0.40},
       "ncf_pmgt": {"test/n20": 0.23, "test/r20": 0.44},
       "dcn_plain": {"test/auc": 0.78}, "dcn_pmgt": {"test/auc": 0.79},
       "pmgt": {"best": 0.92}}
EPS = 1e-9


def _seeds(n):
    """``n`` seeds of port results equal to the JAX record."""
    return [json.loads(json.dumps(JAX)) for _ in range(n)]


def _row(out, check):
    return next(r for r in out["rows"] if r["check"] == check)


@pytest.mark.parametrize("past", [False, True])
@pytest.mark.parametrize("arm,metric,floor", [("ncf_plain", "test/n20", 0.01),
                                              ("ncf_pmgt", "test/r20", 0.01),
                                              ("dcn_plain", "test/auc", 0.005)])
def test_arm_bound_is_the_floor_for_one_seed(arm, metric, floor, past):
    seeds = _seeds(1)
    seeds[0][arm][metric] = JAX[arm][metric] + floor + (1e-6 if past else -EPS)
    out = vp.compare_to_jax(seeds, JAX)
    row = _row(out, f"{arm} {metric}")
    assert row["bound"] == floor and row["ok"] is (not past)


@pytest.mark.parametrize("past", [False, True])
def test_arm_bound_is_three_sigma_when_wider(past):
    # three seeds at mean + 0.02 with sample std 0.01: bound 0.03
    seeds = _seeds(3)
    shift = 0.03 + (1e-6 if past else -EPS)
    for s, x in zip(seeds, (-0.01, 0.0, 0.01)):
        s["dcn_plain"]["test/auc"] = 0.78 + shift + x
        s["dcn_pmgt"]["test/auc"] = 0.79 + shift + x
    row = _row(vp.compare_to_jax(seeds, JAX), "dcn_plain test/auc")
    assert row["std"] == pytest.approx(0.01) and row["bound"] == pytest.approx(0.03)
    assert row["ok"] is (not past)


@pytest.mark.parametrize("past", [False, True])
def test_n20_lift_bound(past):
    jax_lift = 0.23 / 0.20 - 1
    seeds = _seeds(1)
    seeds[0]["ncf_pmgt"]["test/n20"] = 0.20 * (1 + jax_lift + 0.05 + (1e-6 if past else -EPS))
    row = _row(vp.compare_to_jax(seeds, JAX), "ncf_pmgt over ncf_plain test/n20 lift")
    assert row["jax"] == pytest.approx(0.15) and row["ok"] is (not past)


@pytest.mark.parametrize("past", [False, True])
def test_auc_lift_bound(past):
    seeds = _seeds(1)
    seeds[0]["dcn_plain"]["test/auc"] = 0.78 - 0.0025
    seeds[0]["dcn_pmgt"]["test/auc"] = 0.79 + 0.0075 + (1e-6 if past else -EPS)
    row = _row(vp.compare_to_jax(seeds, JAX), "dcn_pmgt over dcn_plain test/auc lift")
    assert row["ok"] is (not past)


@pytest.mark.parametrize("past", [False, True])
def test_neumf_pre_at_or_above_its_towers(past):
    seeds = _seeds(1)
    seeds[0].update(gmf={"test/n20": 0.18}, mlp={"test/n20": 0.21},
                    neumf_pre={"test/n20": 0.21 - 0.005 + (-1e-6 if past else EPS)})
    row = _row(vp.compare_to_jax(seeds, JAX), "neumf_pre test/n20 >= max(gmf, mlp) - 0.005")
    assert row["ok"] is (not past)


@pytest.mark.parametrize("past", [False, True])
def test_pmgt_best_auc_bound(past):
    pmgt = {"best": 0.92 - 0.01 + (-1e-6 if past else EPS)}
    out = vp.compare_to_jax(_seeds(1), JAX, pmgt)
    assert _row(out, "pmgt best val/auc")["ok"] is (not past)
    assert out["ok"] is (not past) and out["misses"] == (["pmgt best val/auc"] if past else [])


def test_quality_record_against_the_jax_record():
    with open(os.path.join(REPO, "QUALITY_TG.json")) as f:
        jax = json.load(f)
    seeds = {k: {a: dict(v) for a, v in jax.items() if a not in ("provenance", "signal")}
             for k in (0, 1, 2)}
    rec = vp.quality_record("TG", seeds, {"commit": "c"}, pmgt=None)
    assert rec["comparison"]["ok"] and not rec["comparison"]["misses"]
    assert "pmgt best val/auc" not in {r["check"] for r in rec["comparison"]["rows"]}
    assert rec["summary"]["ncf_pmgt"]["test/n20"]["std"] == 0.0
    assert sorted(rec["seeds"]) == ["0", "1", "2"]


# ---------------------------------------------------------------- int8 tables

def test_int8_args_equal_the_jax_tools():  # tools/quality_int8_tables.py:29-37
    jax = JTrainArgs(model_name="PMGT", dataset_name="q", seed=0, num_epochs=8,
                     train_batch_size=512, test_batch_size=512, lr=1e-4, mp_enabled=True,
                     gradient_max_norm=5.0,
                     extra=dict(hidden_size=128, intermediate_size=128, num_hidden_layers=5,
                                feat_tables_dtype="int8"))
    assert q8.train_args("int8", 8, 512).to_dict() == jax.to_dict()
    ns = q8.parse([])
    assert (ns.epochs, ns.num_nodes, ns.batch, ns.device) == (8, 10834, 512, "cuda")


def test_int8_tables_track_bf16():
    art = q8.make_dataset(300)
    runs = [q8.run(art, d, 2, 64, "cpu") for d in ("bfloat16", "int8")]
    for r in runs:
        assert len(r["val_auc"]) == 2 and np.isfinite(r["train_loss"]).all()
    v = q8.verdict(*runs)
    assert v["ok"], v
    # the tables really differ, so the agreement is not trivial
    assert runs[0]["train_loss"] != runs[1]["train_loss"]


# ---------------------------------------------------------------- reproduction

@pytest.fixture(scope="module")
def fixture_report(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("repro"))
    path = os.path.join(work, "REPRODUCE_TORCH_fixture.json")
    assert trp.main(["--fixture", "--epochs", "2", "--device", "cpu", "--work-dir", work,
                     "--report", path]) == 0
    with open(path) as f:
        return json.load(f), work


def test_fixture_chain_every_stage_ok(fixture_report):
    report, _ = fixture_report
    assert report["provenance"]["argv"][0] == "--fixture" and report["provenance"]["card"] is None
    assert {e["stage"]: e["status"] for e in report["stages"]} == {
        s: "ok" for s in ("download", "preprocess", "pretrain_h32", "export_h32",
                          "neumf_pmgt", "dcn_pmgt", "compare")}
    export = next(e for e in report["stages"] if e["stage"] == "export_h32")
    emb = np.load(export["path"])
    assert emb.shape == (63, 32) and np.isfinite(emb).all()  # as REPRODUCE_fixture.json
    for stage in ("neumf_pmgt", "dcn_pmgt"):
        metrics = next(e for e in report["stages"] if e["stage"] == stage)["metrics"]
        assert metrics and all(np.isfinite(v) for v in metrics.values()), stage


def test_real_mode_records_the_blocked_download(tmp_path, monkeypatch):
    from pmgt_tpu_torch.data import ingest

    def no_network(*a, **k):
        raise OSError("[Errno 101] Network is unreachable (test stub)")

    monkeypatch.setattr(ingest, "download_reviews", no_network)
    report = trp.run_real("VG", str(tmp_path), device="cpu")
    statuses = {e["stage"]: e["status"] for e in report["stages"]}
    assert statuses == {"download": "blocked", "features": "blocked"}
    dl = report["stages"][0]
    assert "Network is unreachable" in dl["error"]
    features = report["stages"][1]
    assert features["inception_v4"].startswith("ExtractorUnavailable")
    assert features["bert"].startswith("ExtractorUnavailable")
    for needle in ("deepyeti", "reviews.json.gz", "feats.npz"):
        assert needle in report["blocker"]


@pytest.fixture(scope="module")
def jrp():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import reproduce_published
    finally:
        sys.path.remove(os.path.join(REPO, "tools"))
    return reproduce_published


def test_targets_primary_tolerance_equal_the_jax_tools(jrp):
    assert (trp.TARGETS, trp.PRIMARY, trp.TOLERANCE) == (jrp.TARGETS, jrp.PRIMARY, jrp.TOLERANCE)


def _entry(metrics):
    return None if metrics is None else {"status": "ok", "metrics": metrics}


@pytest.mark.parametrize("dataset,ncf,dcn", [
    ("VG", {"test/n20": 0.2060, "test/r20": 0.3700}, None),
    ("VG", {"test/n20": 0.19, "test/r20": 0.3661}, None),
    ("VG", {"test/n20": 0.2046, "test/r20": 0.3624}, {"test/auc": 0.5}),
    ("TG", None, {"test/auc": 0.8490}),
    ("TG", None, {"test/auc": 0.8400}),
    ("TG", {"test/n20": 0.1}, {"test/auc": 0.8401}),
    ("TG", None, None),
])
def test_stage_compare_verdicts_equal_the_jax_tools(jrp, dataset, ncf, dcn):
    jrep, trep = {"stages": []}, {"stages": []}
    want = jrp.stage_compare(jrep, dataset, _entry(ncf), _entry(dcn))
    got = trp.stage_compare(trep, dataset, _entry(ncf), _entry(dcn))
    assert got == want


# ---------------------------------------------------------------- data

@pytest.mark.parametrize("shape", ["VG", "TG"])
def test_published_shape_datasets_equal_the_jax_packages(shape):
    signal = tsynthetic.CALIBRATED_SIGNAL[shape]
    t = tsynthetic.make_published_shape_dataset(shape, seed=vp.DATA_SEED, signal=signal)
    j = jsynthetic.make_published_shape_dataset(shape, seed=vp.DATA_SEED, signal=signal)
    for name in ("nbr_ids", "nbr_logits", "degrees", "nbr_sorted"):
        np.testing.assert_array_equal(getattr(t.graph, name), getattr(j.graph, name), name)
    for a, b in zip(t.feat_init_embs, j.feat_init_embs, strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for name in ("train_pairs", "test_pairs"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, name)
    assert (t.num_users, t.num_items, t.num_nodes) == (j.num_users, j.num_items, j.num_nodes)
    # the downstream train/valid pairs at each seed, and PMGT's node split
    for seed in (0, 1, 2):
        for a, b in zip(tinteractions.train_valid_split(t.train_pairs, 0.2, seed),
                        jinteractions.train_valid_split(j.train_pairs, 0.2, seed), strict=True):
            np.testing.assert_array_equal(a, b)
    nodes = np.arange(2, t.num_nodes + 2, dtype=np.int32)
    for a, b in zip(tpmgt_task.train_valid_split(nodes, 0.1, 0),  # pmgt_task.py:777-779
                    train_test_split(nodes, test_size=0.1, random_state=0), strict=True):
        np.testing.assert_array_equal(a, b)


def _load_without_pickle_packages() -> str:
    """A program that loads the fixture with pandas, joblib, networkx and
    sklearn unimportable and saves what it read to ``argv[1]``."""
    return (
        "import sys\n"
        "for m in ('pandas', 'joblib', 'networkx', 'sklearn'): sys.modules[m] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from pmgt_tpu_torch.data.artifacts import load_artifacts\n"
        f"a = load_artifacts({os.path.join(FIXTURE, 'data')!r}, 'MINI')\n"
        "import numpy as np\n"
        f"np.savez({'{}'!r}.format(sys.argv[1]), train=a.train_pairs, test=a.test_pairs,"
        " deg=a.graph.degrees, ids=a.graph.nbr_ids, items=a.item_classes.astype(str))\n"
    )


def test_reference_loader_runs_without_pandas_joblib_networkx(tmp_path):
    out = str(tmp_path / "mini.npz")
    subprocess.run([sys.executable, "-c", _load_without_pickle_packages(), out],
                   check=True, timeout=120)
    full = tartifacts.load_artifacts(os.path.join(FIXTURE, "data"), "MINI")
    with np.load(out) as z:
        np.testing.assert_array_equal(z["train"], full.train_pairs)
        np.testing.assert_array_equal(z["test"], full.test_pairs)
        np.testing.assert_array_equal(z["deg"], full.graph.degrees)
        np.testing.assert_array_equal(z["ids"], full.graph.nbr_ids)
        assert z["items"].tolist() == full.item_classes.astype(str).tolist()


class _Evil:
    def __reduce__(self):
        return (os.system, ("true",))


def test_reference_reader_refuses_foreign_classes(tmp_path):
    path = tmp_path / "graph.gpickle"
    path.write_bytes(pickle.dumps(_Evil()))
    with pytest.raises(pickle.UnpicklingError, match="not in the reference layout"):
        tartifacts.read_reference_pickle(str(path))


def test_reference_reader_reads_object_label_classes(tmp_path):
    """Encoders fitted on pandas columns hold object arrays, which joblib
    pickles inside its stream."""
    import joblib
    from sklearn.preprocessing import LabelEncoder

    enc = LabelEncoder().fit(np.array(["b", "a", "c", "a"], dtype=object))
    joblib.dump(enc, tmp_path / "item_encoder")
    got = tartifacts.read_reference_pickle(str(tmp_path / "item_encoder"))
    assert got.classes_.dtype == object and got.classes_.tolist() == ["a", "b", "c"]
