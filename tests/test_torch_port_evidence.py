"""The port's evidence tools against the JAX package's (CPU, small sizes).

- ``tools/dcn_sensitivity``: each stage's ``TrainArgs`` is the JAX tool's,
  transcribed with its ``file:line`` (the JAX tool parses its flags at
  import, so it cannot be imported); the variants bit-equal to a numpy
  recomputation of its lines; the analysis reproduces both JAX records
  from their AUCs; ``compare_to_jax`` at each bound and just past it; end
  to end with one seed and one epoch, without and with ``--freeze``.
- ``tools/neumf_pre_bisect``: the same for its arms and its ladder, and
  end to end at one epoch.
- PMGT_NCF's quality bound against ``QUALITY_TG_PMGT_NCF.json``.

The module trains on one thread, and its subprocesses too.
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from pmgt_tpu.core.config import TrainArgs as JTrainArgs
from pmgt_tpu_torch.data.synthetic import make_synthetic_dataset
from pmgt_tpu_torch.tools import dcn_sensitivity as ds
from pmgt_tpu_torch.tools import neumf_pre_bisect as nb
from pmgt_tpu_torch.tools import validate_pipeline as vp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS = 1e-9


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads, omp = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(threads)
    if omp is None:
        os.environ.pop("OMP_NUM_THREADS")
    else:
        os.environ["OMP_NUM_THREADS"] = omp


def _record(name):
    with open(os.path.join(REPO, name)) as f:
        return json.load(f)


# ---------------------------------------------------------------- DCN sensitivity
# The JAX tool's arguments, transcribed: tools/dcn_sensitivity.py.
def _jax_dcn_pmgt(epochs):  # :81-90
    return JTrainArgs(
        model_name="PMGT", dataset_name="Q", seed=0,
        num_epochs=epochs,
        train_batch_size=256, test_batch_size=512, lr=1e-4, decay=1e-2,
        early=5, early_criterion="auc", valid_size=0.1, mp_enabled=True,
        gradient_max_norm=5.0, ckpt_interval=1_000_000,
        log_dir="OUT/logs",
        extra=dict(hidden_size=128, intermediate_size=128,
                   num_hidden_layers=5))


def _jax_dcn(seed, epochs, emb_p, freeze):  # :119-138 (run_dcn)
    extra = dict(
        factor_num=32, deep_net_num_layers=2, cross_net_num_layers=3,
        num_ng=1, max_sample_items=5, emb_dropout=0.2, use_layer_norm=True,
    )
    if emb_p:
        extra.update(item_init_emb_path=emb_p, normalize_item_init_emb=True,
                     freeze_item_init_emb=freeze)
    return JTrainArgs(
        model_name="DCN", dataset_name="Q", seed=seed,
        num_epochs=epochs,
        train_batch_size=256, test_batch_size=512, lr=1e-3, decay=1e-3,
        early=4, early_criterion="auc", valid_size=0.2, mp_enabled=True,
        gradient_max_norm=5.0, ckpt_interval=1_000_000,
        log_dir="OUT/logs", extra=extra)


def _dcn_ns(*extra):
    return ds.parse(["--out", "OUT", *extra])


DCN_STAGES = {
    "pmgt": (lambda: ds.pmgt_args(_dcn_ns()), lambda: _jax_dcn_pmgt(8)),
    "plain": (lambda: ds.dcn_args(_dcn_ns(), 2, None, "OUT/logs"),
              lambda: _jax_dcn(2, 12, None, False)),
    "variant": (lambda: ds.dcn_args(_dcn_ns(), 1, "E.npy", "OUT/logs"),
                lambda: _jax_dcn(1, 12, "E.npy", False)),
    "variant_frozen": (lambda: ds.dcn_args(_dcn_ns("--freeze"), 0, "E.npy", "OUT/logs"),
                       lambda: _jax_dcn(0, 12, "E.npy", True)),
    "plain_frozen": (lambda: ds.dcn_args(_dcn_ns("--freeze"), 0, None, "OUT/logs"),
                     lambda: _jax_dcn(0, 12, None, True)),
}


@pytest.mark.parametrize("stage", sorted(DCN_STAGES))
def test_dcn_stage_args_equal_the_jax_tools(stage):
    port, jax = DCN_STAGES[stage]
    assert port().to_dict() == jax().to_dict()


def test_dcn_flags_and_defaults_equal_the_jax_tools():  # tools/dcn_sensitivity.py:37-54
    ns = ds.parse([])
    assert (ns.shape, ns.signal, ns.pmgt_epochs, ns.downstream_epochs, ns.seeds, ns.emb_path,
            ns.freeze, ns.report) == ("TG", None, 8, 12, "0,1,2", None, False, None)
    assert ns.device == "cuda" and ns.worker_seed is None


def test_variants_bit_equal_numpy():  # tools/dcn_sensitivity.py:104-112
    emb = np.random.default_rng(5).normal(size=(97, 16)).astype(np.float32)
    rng = np.random.default_rng(0)
    perm = rng.permutation(len(emb))
    want = {"real": emb, "nerf50": 0.5 * emb + 0.5 * emb[perm], "zero": np.zeros_like(emb)}
    got = ds.variants(emb)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k].astype(np.float32))


@pytest.mark.parametrize("name", ["DCN_SENSITIVITY_TG.json", "DCN_SENSITIVITY_TG_FROZEN.json"])
def test_analysis_reproduces_the_jax_records(name):
    jax = _record(name)
    out = ds.analyse(jax["auc"], [0, 1, 2])
    # the record's AUCs are rounded to 1e-5, so lifts (in points) can move
    # by one unit of the record's last digit
    assert out["auc"] == jax["auc"]
    for key in ("lift_pts", "mean_lift_pts"):
        for arm, v in jax[key].items():
            np.testing.assert_allclose(out[key][arm], v, atol=1e-3 + EPS)
    np.testing.assert_allclose(out["real_minus_nerf50_pts"], jax["real_minus_nerf50_pts"],
                               atol=1e-3 + EPS)
    for key in ("contrast_mean_pts", "contrast_sigma_pts"):
        assert out[key] == pytest.approx(jax[key], abs=1e-3 + EPS)
    key = "half_lift_regression_detectable_at_2sigma"
    assert out[key] is jax[key]


def _dcn_report(freeze, shift=0.0, zero=0.5):
    jax = _record("DCN_SENSITIVITY_TG_FROZEN.json" if freeze
                  else "DCN_SENSITIVITY_TG.json")
    auc = {k: v + (shift if k.startswith("plain") else 0.0) for k, v in jax["auc"].items()}
    if freeze:
        auc.update({f"zero_s{s}": zero for s in range(3)})
    rep = dict(ds.analyse(auc, [0, 1, 2]), freeze=freeze, auc_exact=auc)
    return rep, jax


def test_dcn_compare_holds_the_jax_records_to_themselves():
    for freeze in (False, True):
        rep, jax = _dcn_report(freeze)
        out = ds.compare_to_jax(rep, jax)
        assert out["ok"] and not out["misses"], out


@pytest.mark.parametrize("past", [False, True])
def test_dcn_arm_bound_is_the_floor_when_seeds_agree(past):
    # every seed moved by the same amount: σ stays JAX's, the floor rules
    rep, jax = _dcn_report(False)
    std = vp.mean_std([v for k, v in jax["auc"].items() if k.startswith("plain")])["std"]
    assert 3 * std < 0.005
    rep, _ = _dcn_report(False, shift=0.005 + (1e-6 if past else -EPS))
    row = next(r for r in ds.compare_to_jax(rep, jax)["rows"]
               if r["check"] == "plain mean test/auc")
    assert row["bound"] == pytest.approx(0.005) and row["ok"] is (not past)


@pytest.mark.parametrize("past", [False, True])
def test_dcn_frozen_zero_arm_is_exactly_half(past):
    rep, jax = _dcn_report(True, zero=0.5 + (1e-12 if past else 0.0))
    out = ds.compare_to_jax(rep, jax)
    row = next(r for r in out["rows"] if r["check"].startswith("frozen zero arm"))
    assert row["ok"] is (not past)


def test_dcn_verdict_must_equal_jaxs():
    rep, jax = _dcn_report(True)
    rep["half_lift_regression_detectable_at_2sigma"] = True
    assert ds.compare_to_jax(rep, jax)["misses"] == ["detectable verdict equals JAX's"]


@pytest.fixture(scope="module")
def dcn_reports(tmp_path_factory):
    """The tool end to end on a small dataset: the PMGT stage and one seed
    of one epoch, then ``--freeze`` on the same export."""
    root = str(tmp_path_factory.mktemp("dcn"))
    art = make_synthetic_dataset(num_nodes=300, num_users=150, feat_dims=(64, 32), seed=42)
    out = {}
    for freeze in (False, True):
        d = os.path.join(root, f"f{int(freeze)}")
        argv = ["--out", d, "--report", d + ".json", "--seeds", "0", "--pmgt-epochs", "1",
                "--downstream-epochs", "1", "--device", "cpu"]
        if freeze:
            argv += ["--freeze", "--emb-path", os.path.join(root, "f0", "node_feat_128dim.npy")]
        assert ds.main(argv, art=art) == 0
        with open(d + ".json") as f:
            out[freeze] = json.load(f)
    return out


@pytest.mark.parametrize("freeze", [False, True])
def test_dcn_end_to_end_writes_the_jax_tools_keys(dcn_reports, freeze):
    rep = dcn_reports[freeze]
    jax = _record("DCN_SENSITIVITY_TG_FROZEN.json")  # the newer record: every key
    assert set(jax) <= set(rep)
    assert set(rep["auc"]) == {f"{a}_s0" for a in ds.ARMS}
    for key in ("lift_pts", "mean_lift_pts"):
        assert set(rep[key]) == set(ds.VARIANTS)
    nums = [*rep["auc"].values(), *rep["mean_lift_pts"].values(), rep["contrast_mean_pts"],
            rep["contrast_sigma_pts"], *[x for v in rep["lift_pts"].values() for x in v]]
    assert np.isfinite(nums).all()
    assert rep["freeze"] is freeze and (rep["pmgt"] is None) is freeze
    assert rep["provenance"]["card"] is None and len(rep["provenance"]["source_sha256"]) == 64
    if freeze:  # a frozen zero table scores every item alike, as in JAX
        assert rep["auc_exact"]["zero_s0"] == 0.5
    assert {r["check"] for r in ds.compare_to_jax(rep, jax)["rows"]} >= {
        "plain mean test/auc", "detectable verdict equals JAX's"}


# ---------------------------------------------------------------- NeuMF-pre bisect
def _jax_bisect(model_name, lr, num_epochs, extra):  # tools/neumf_pre_bisect.py:78-85, :108-113
    return JTrainArgs(
        model_name=model_name, dataset_name="Q", seed=0,
        num_epochs=num_epochs,
        train_batch_size=256, test_batch_size=512, lr=lr, decay=0.0,
        early=4, early_criterion="n20", valid_size=0.2, mp_enabled=True,
        gradient_max_norm=5.0, ckpt_interval=1_000_000,
        log_dir="OUT/logs", extra=dict(extra))


JAX_BASE = dict(factor_num=64, num_layers=2, num_ng=1, max_sample_items=500)  # :100
JAX_PRE = dict(JAX_BASE, gmf_run_id="G", mlp_run_id="M", alpha=0.5)  # :104
BNS = nb.parse(["--out", "OUT"])
BISECT_STAGES = {
    "gmf": (lambda: nb.ncf_args(BNS, "GMF", 1e-3, 12, nb.BASE),
            lambda: _jax_bisect("GMF", 1e-3, 12, JAX_BASE)),  # :101
    "mlp": (lambda: nb.ncf_args(BNS, "MLP", 1e-3, 12, nb.BASE),
            lambda: _jax_bisect("MLP", 1e-3, 12, JAX_BASE)),  # :102
    "init_only": (lambda: nb.ncf_args(BNS, "NeuMF-pre", 1e-4, 0, nb.fused_extra("G", "M")),
                  lambda: _jax_bisect("NeuMF-pre", 1e-4, 0, JAX_PRE)),  # :108-113
    "lr1e-3": (lambda: nb.ncf_args(BNS, "NeuMF-pre", 1e-3, 12, nb.fused_extra("G", "M")),
               lambda: _jax_bisect("NeuMF-pre", 1e-3, 12, JAX_PRE)),  # :134
    "lr1e-4_e36": (lambda: nb.ncf_args(BNS, "NeuMF-pre", 1e-4, 36, nb.fused_extra("G", "M")),
                   lambda: _jax_bisect("NeuMF-pre", 1e-4, 36, JAX_PRE)),
}


@pytest.mark.parametrize("stage", sorted(BISECT_STAGES))
def test_bisect_stage_args_equal_the_jax_tools(stage):
    port, jax = BISECT_STAGES[stage]
    assert port().to_dict() == jax().to_dict()


def test_bisect_ladder_and_defaults_equal_the_jax_tools():  # :29-37, :124-134
    ns = nb.parse([])
    assert (ns.shape, ns.num_nodes, ns.num_users, ns.epochs, ns.lrs, ns.report) == (
        None, 800, 600, 12, "1e-3,1e-4", None)
    assert ns.device == "cuda"
    assert nb.ladder("1e-3,1e-4,1e-4:36", 12) == [
        ("neumf_pre_lr1e-3_e12", 1e-3, 12), ("neumf_pre_lr1e-4_e12", 1e-4, 12),
        ("neumf_pre_lr1e-4_e36", 1e-4, 36)]
    # the record's arms are the ladder's names
    assert {n for n, _, _ in nb.ladder("1e-3,1e-4,1e-4:36", 12)} <= set(
        _record("QUALITY_NEUMF_PRE_BISECT_TG.json")["full"])


def test_bisect_small_dataset_is_the_jax_tools():  # :64-72
    from pmgt_tpu.data.synthetic import make_synthetic_dataset as jmake

    art, signal = nb.make_dataset(nb.parse(["--num-nodes", "120", "--num-users", "90"]))
    want = jmake(num_nodes=120, num_users=90, num_clusters=12, feat_dims=(64, 32),
                 interactions_per_user=15, avg_degree=10, seed=42)
    assert signal is None
    np.testing.assert_array_equal(art.train_pairs, want.train_pairs)
    np.testing.assert_array_equal(art.feat_init_embs[0], want.feat_init_embs[0])


def _bisect_report(**over):
    """The JAX record's N@20 as a port report, with ``over`` changed."""
    jax = _record("QUALITY_NEUMF_PRE_BISECT_TG.json")
    n20 = {k: v["test/n20"] for k, v in jax["full"].items()}
    n20.update(over)
    return {"results_n20": n20}, jax


def test_bisect_compare_holds_the_jax_record_to_itself():
    rep, jax = _bisect_report()
    out = nb.compare_to_jax(rep, jax)
    assert out["ok"] and not out["misses"], out


@pytest.mark.parametrize("past", [False, True])
def test_bisect_arm_bound(past):
    jax = _record("QUALITY_NEUMF_PRE_BISECT_TG.json")
    rep, _ = _bisect_report(mlp=jax["full"]["mlp"]["test/n20"] - 0.01 - (1e-6 if past else -EPS))
    row = next(r for r in nb.compare_to_jax(rep, jax)["rows"] if r["check"] == "mlp test/n20")
    assert row["ok"] is (not past)


@pytest.mark.parametrize("past", [False, True])
def test_bisect_findings(past):
    jax = _record("QUALITY_NEUMF_PRE_BISECT_TG.json")
    init = jax["full"]["neumf_pre_init_only"]["test/n20"]
    # init-only at its floor, and the lr 1e-3 arm just under its ceiling
    rep, _ = _bisect_report(gmf=0.2, mlp=init + 0.005 + (1e-6 if past else -EPS))
    row = next(r for r in nb.compare_to_jax(rep, jax)["rows"]
               if r["check"].startswith("init-only"))
    assert row["ok"] is (not past)
    rep, _ = _bisect_report(**{"neumf_pre_lr1e-3_e12": init - 0.02 + (0 if past else -1e-6)})
    row = next(r for r in nb.compare_to_jax(rep, jax)["rows"]
               if r["check"].startswith("neumf_pre_lr1e-3_e12 <"))
    assert row["ok"] is (not past)


def test_bisect_end_to_end_at_one_epoch(tmp_path):
    report_path = str(tmp_path / "r.json")
    argv = ["--device", "cpu", "--num-nodes", "200", "--num-users", "150", "--epochs", "1",
            "--lrs", "1e-3,1e-4:2", "--out", str(tmp_path / "o"), "--report", report_path]
    assert nb.main(argv) == 0
    with open(report_path) as f:
        rep = json.load(f)
    keys = {"lr", "test/loss", "test/n10", "test/r10", "test/n20", "test/r20"}
    jax = _record("QUALITY_NEUMF_PRE_BISECT_TG.json")
    assert set(jax["full"]["gmf"]) == keys
    assert set(rep["full"]) == {"gmf", "mlp", "neumf_pre_init_only", "neumf_pre_lr1e-3_e1",
                                "neumf_pre_lr1e-4_e2"}
    for arm, metrics in rep["full"].items():
        assert set(metrics) == keys and np.isfinite(list(metrics.values())).all(), arm
    assert rep["full"]["neumf_pre_init_only"]["lr"] == 0.0
    assert rep["results_n20"] == {k: v["test/n20"] for k, v in rep["full"].items()}
    out = nb.compare_to_jax(rep, jax)
    assert {r["check"] for r in out["rows"]} >= {"gmf test/n20", "mlp test/n20",
                                                "init-only >= max(gmf, mlp) - 0.005"}


# ---------------------------------------------------------------- PMGT_NCF at TG
PMGT_NCF = _record("QUALITY_TG_PMGT_NCF.json")


@pytest.mark.parametrize("past", [False, True])
@pytest.mark.parametrize("metric", ["test/n20", "test/r20"])
def test_pmgt_ncf_bound_is_the_floor_for_one_seed(metric, past):
    seeds = [{"pmgt_ncf": dict(PMGT_NCF["pmgt_ncf"])}]
    seeds[0]["pmgt_ncf"][metric] += 0.01 + (1e-6 if past else -EPS)
    row = next(r for r in vp.compare_to_jax(seeds, PMGT_NCF)["rows"]
               if r["check"] == f"pmgt_ncf {metric}")
    assert row["bound"] == 0.01 and row["ok"] is (not past)


@pytest.mark.parametrize("past", [False, True])
def test_pmgt_ncf_bound_is_three_sigma_when_wider(past):
    shift = 0.03 + (1e-6 if past else -EPS)
    seeds = [{"pmgt_ncf": dict(PMGT_NCF["pmgt_ncf"])} for _ in range(3)]
    for s, x in zip(seeds, (-0.01, 0.0, 0.01)):
        s["pmgt_ncf"]["test/n20"] += shift + x
    row = next(r for r in vp.compare_to_jax(seeds, PMGT_NCF)["rows"]
               if r["check"] == "pmgt_ncf test/n20")
    assert row["bound"] == pytest.approx(0.03) and row["ok"] is (not past)


def test_quality_record_against_the_pmgt_ncf_record():
    seeds = {k: {"pmgt_ncf": dict(PMGT_NCF["pmgt_ncf"])} for k in (0, 1, 2)}
    rec = vp.quality_record("TG", seeds, {"commit": "c"}, pmgt=dict(PMGT_NCF["pmgt"]),
                            jax_name="QUALITY_TG_PMGT_NCF.json")
    checks = {r["check"] for r in rec["comparison"]["rows"]}
    assert checks == {"pmgt_ncf test/n20", "pmgt_ncf test/r20", "pmgt best val/auc"}
    assert rec["comparison"]["ok"] and rec["jax_record"] == "QUALITY_TG_PMGT_NCF.json"
    assert sorted(rec["seeds"]) == ["0", "1", "2"] and set(rec["summary"]) == {"pmgt_ncf"}
