"""The port's engine, checkpoints and run registry against the JAX
package's.

- Decision parity: fake tasks with the same scripted ``val/*`` sequences
  and per-step losses run through ``pmgt_tpu.train.engine.fit`` and the
  port's ``fit`` (early stopping, ``eval_interval``, ``ckpt_interval``,
  ``eval_init``, SWA, loss and auc criteria). Both must write the same
  ``metrics.jsonl`` rows (name, epoch, step, value; ``epoch_time`` aside),
  the same ``best.json``, the same ``best/``/``last/``/``swa/`` presence and
  status, and return the same results.
- Checkpoints: round trip, crash recovery from a stranded aside copy, and
  the double fault of the JAX package's finalize (deleting the aside copy
  before the new one is in place) does not happen in the port.
- SIGTERM during an epoch gives INTERRUPTED and a resumable ``last``; the
  resumed run finishes.
- On a small ``PMGTTask(device="cpu")``: 2 epochs then a resume to 3 equal
  3 epochs straight, bit for bit (with deterministic algorithms), in
  losses, parameters and logged rows; restoring
  ``best`` reproduces its logged ``val/auc`` exactly.
"""
from __future__ import annotations

import json
import os
import shutil
import signal
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmgt_tpu.train import engine as jengine
from pmgt_tpu.train.registry import RunRegistry as JRunRegistry
from pmgt_tpu_torch.core.config import TrainArgs
from pmgt_tpu_torch.data.synthetic import make_synthetic_dataset
from pmgt_tpu_torch.tasks.pmgt_task import PMGTTask, init_dataloader
from pmgt_tpu_torch.train import checkpoints as tckpt
from pmgt_tpu_torch.train import engine as tengine
from pmgt_tpu_torch.train.registry import RunRegistry, locate_eval_ckpt

STEPS = 3  # steps per epoch of the fake tasks


def _step_losses(epoch):
    return np.asarray([1.0 / (1 + epoch) + 0.01 * i for i in range(STEPS)], np.float32)


class _Script:
    """The scripted validation sequence shared by both fakes."""

    def __init__(self, seq, criterion):
        self.seq, self.criterion, self.evals = seq, criterion, 0

    def next(self):
        v = self.seq[min(self.evals, len(self.seq) - 1)]
        self.evals += 1
        return {f"val/{self.criterion}": v, "val/other": 1.0 - v}


class JState(NamedTuple):
    params: dict
    count: jnp.ndarray


class JaxFake:
    """The JAX engine's task protocol, per-step path."""

    def __init__(self, seq, criterion):
        self.script = _Script(seq, criterion)
        self.state = JState({"w": jnp.zeros((2,))}, jnp.asarray(0))

    def on_epoch_start(self, epoch):
        pass

    def train_batches(self, epoch):
        for i in range(STEPS):
            yield epoch, i

    def train_step(self, state, batch):
        epoch, i = batch
        state = state._replace(params={"w": state.params["w"] + 1.0},
                               count=state.count + 1)
        return state, {"loss": jnp.asarray(_step_losses(epoch)[i])}

    def evaluate(self, state, split):
        return self.script.next()


class TorchFake:
    """The port engine's task protocol."""

    def __init__(self, seq, criterion):
        self.script = _Script(seq, criterion)
        self.model = torch.nn.Linear(2, 1)
        self.count = 0

    def train_epoch(self, epoch):
        with torch.no_grad():
            self.model.weight.add_(1.0)
        self.count += STEPS
        return torch.from_numpy(_step_losses(epoch))

    def evaluate(self, split):
        return self.script.next()

    def state_dict(self):
        return {"model": self.model.state_dict(), "count": self.count}

    def load_state_dict(self, state):
        self.model.load_state_dict(state["model"])
        self.count = int(state["count"])


SCENARIOS = {
    "early_stop_groups": dict(
        seq=[0.5, 0.6, 0.55, 0.7, 0.65, 0.64, 0.63, 0.9], criterion="auc",
        kw=dict(num_epochs=14, early=2, eval_interval=2, ckpt_interval=2,
                eval_init=True)),
    "init_wins": dict(
        seq=[0.9, 0.6, 0.7, 0.65], criterion="auc",
        kw=dict(num_epochs=3, early=5, eval_init=True, ckpt_interval=2)),
    "loss_ragged_groups": dict(
        seq=[0.4, 0.3, 0.35, 0.36, 0.2], criterion="loss",
        kw=dict(num_epochs=8, early=3, eval_interval=3, ckpt_interval=2)),
    "swa": dict(
        seq=[0.5, 0.6, 0.7, 0.65, 0.8], criterion="auc",
        kw=dict(num_epochs=4, early=5, swa_start=1)),
}


def _rows(run):
    return [(m["name"], m["epoch"], m["step"], m["value"])
            for m in run.metrics() if m["name"] != "epoch_time"]


def _listing(run):
    ck = run.ckpt_dir
    best = None
    if os.path.exists(os.path.join(ck, "best.json")):
        with open(os.path.join(ck, "best.json")) as f:
            best = json.load(f)
    return best, {n: os.path.isdir(os.path.join(ck, n)) for n in ("best", "last", "swa")}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_fit_makes_the_jax_engines_decisions(tmp_path, name):
    sc = SCENARIOS[name]
    jreg = JRunRegistry(str(tmp_path / "jax"))
    jrun = jreg.create_run("exp", {})
    jtask = JaxFake(sc["seq"], sc["criterion"])
    jres = jengine.fit(jtask, early_criterion=sc["criterion"], registry=jreg,
                       run=jrun, log_every=0, **sc["kw"])

    treg = RunRegistry(str(tmp_path / "torch"))
    trun = treg.create_run("exp", {})
    ttask = TorchFake(sc["seq"], sc["criterion"])
    tres = tengine.fit(ttask, early_criterion=sc["criterion"], registry=treg,
                       run=trun, **sc["kw"])

    assert _rows(trun) == _rows(jrun)
    assert _listing(trun) == _listing(jrun)
    assert trun.status == jrun.status == "RUNNING"  # the CLI finalizes it
    assert tres == jres
    assert ttask.script.evals == jtask.script.evals
    if name == "swa":
        # the average of the end-of-epoch weights of epochs 1..3: each
        # epoch adds 1, so the mean is the last weight less 1
        payload = tckpt.restore_checkpoint(os.path.join(trun.ckpt_dir, "swa"))
        assert payload["n_models"] == 3
        torch.testing.assert_close(payload["params"]["weight"],
                                   ttask.model.weight.detach() - 1.0)


def test_fit_resumes_from_last(tmp_path):
    reg = RunRegistry(str(tmp_path))
    run = reg.create_run("exp", {})
    task = TorchFake([0.5, 0.8, 0.6], "auc")
    tengine.fit(task, num_epochs=3, early=5, early_criterion="auc",
                registry=reg, run=run)
    calls = []

    class Resumable(TorchFake):
        def on_resume(self, global_step, start_epoch):
            calls.append((global_step, start_epoch))

    task2 = Resumable([0.9], "auc")
    res = tengine.fit(task2, num_epochs=5, early=5, early_criterion="auc",
                      registry=reg, run=run, resume=True)
    assert calls == [(3 * STEPS, 3)]
    assert task2.count == 5 * STEPS and task2.script.evals == 2
    assert res["best"] == pytest.approx(0.9)
    meta = tckpt.restore_checkpoint(os.path.join(run.ckpt_dir, "last"))["meta"]
    assert (meta["epoch"], meta["global_step"]) == (4, 5 * STEPS)


# ---- checkpoints ------------------------------------------------------

def _payload(x):
    return {"state": {"t": torch.full((3,), float(x)), "n": x}, "meta": {"epoch": x}}


def _value(path):
    return int(tckpt.restore_checkpoint(path)["meta"]["epoch"])


def test_checkpoint_round_trip_and_overwrite(tmp_path):
    p = str(tmp_path / "last")
    tckpt.save_checkpoint(p, _payload(1))
    tckpt.save_checkpoint(p, _payload(2))
    out = tckpt.restore_checkpoint(p)
    torch.testing.assert_close(out["state"]["t"], torch.full((3,), 2.0))
    assert out["state"]["n"] == 2 and sorted(os.listdir(tmp_path)) == ["last"]
    tckpt.write_best_info(str(tmp_path), "val/auc", 0.5, 3)
    assert tckpt.read_best_info(str(tmp_path)) == {"monitor": "val/auc", "value": 0.5, "epoch": 3}
    assert tckpt.read_best_info(str(tmp_path / "none")) is None


def test_checkpoint_to_several_paths_serializes_once(tmp_path, monkeypatch):
    calls = []
    real_save = tckpt.torch.save
    monkeypatch.setattr(tckpt.torch, "save", lambda *a, **k: calls.append(1) or real_save(*a, **k))
    paths = [str(tmp_path / "last"), str(tmp_path / "best")]
    tckpt.save_checkpoint(paths, _payload(1))
    tckpt.save_checkpoint(paths, _payload(2))
    assert len(calls) == 2 and [_value(p) for p in paths] == [2, 2]
    assert sorted(os.listdir(tmp_path)) == ["best", "last"]


def test_checkpoint_exists_promotes_a_stranded_aside_copy(tmp_path):
    p = str(tmp_path / "last")
    tckpt.save_checkpoint(p, _payload(1))
    os.replace(p, p + ".old")  # a kill between finalize's two renames
    assert tckpt.checkpoint_exists(p) and _value(p) == 1
    assert not os.path.exists(p + ".old")


def test_finalize_never_deletes_the_only_complete_copy(tmp_path, monkeypatch):
    """The JAX finalize's retry deletes the aside copy before the new one
    is in place; the port keeps it until the new copy has landed."""
    p = str(tmp_path / "last")
    tckpt.save_checkpoint(p, _payload(1))
    real_replace, real_rmtree = os.replace, shutil.rmtree
    fail = {"on": True}

    def replace(src, dst):
        if fail["on"] and src.endswith(".tmp_new"):
            raise OSError("injected: rename of the new copy failed")
        return real_replace(src, dst)

    def rmtree(path, *a, **k):
        # Deleting the aside copy is only safe with a complete `last`.
        if str(path).endswith(".old"):
            assert os.path.isdir(p), "the only complete copy was deleted"
        return real_rmtree(path, *a, **k)

    monkeypatch.setattr(tckpt.os, "replace", replace)
    monkeypatch.setattr(tckpt.shutil, "rmtree", rmtree)
    with pytest.raises(OSError, match="injected"):
        tckpt.save_checkpoint(p, _payload(2))
    assert not os.path.isdir(p) and os.path.isdir(p + ".old")  # aside, stranded
    with pytest.raises(OSError, match="injected"):
        tckpt.save_checkpoint(p, _payload(3))  # the retry fails as well
    assert os.path.isdir(p + ".old") and _value(p + ".old") == 1
    fail["on"] = False
    tckpt.save_checkpoint(p, _payload(4))
    assert _value(p) == 4 and not os.path.exists(p + ".old")
    # and a crash that strands the aside copy still resumes from it
    real_replace(p, p + ".old")
    assert tckpt.checkpoint_exists(p) and _value(p) == 4


def test_registry_layout_and_lookup(tmp_path):
    reg = RunRegistry(str(tmp_path))
    run = reg.create_run("expA", {"x": 1}, run_name="r", tags={"t": "v"})
    assert sorted(os.listdir(run.run_dir)) == ["artifacts", "checkpoints", "params.json",
                                               "status", "tags.json"]
    assert reg.get_run(run.run_id).params == {"x": 1} and run.status == "RUNNING"
    reg.log_metrics(run, {"val/auc": 0.5}, step=3, epoch=1)
    assert run.metrics() == [{"step": 3, "epoch": 1, "name": "val/auc", "value": 0.5}]
    # the JAX package's registry reads the port's run directory
    jrun = JRunRegistry(str(tmp_path)).get_run(run.run_id)
    assert jrun.params == {"x": 1} and jrun.metrics() == run.metrics()
    assert [r.run_id for r in reg.list_runs()] == [run.run_id]
    with pytest.raises(FileNotFoundError):
        reg.get_run("nonexistent")
    with pytest.raises(FileNotFoundError):
        reg.get_ckpt_path(run.run_id)
    assert locate_eval_ckpt(reg, run, None) is None  # just trained: warn only
    with pytest.raises(FileNotFoundError, match="refusing"):
        locate_eval_ckpt(reg, None, run.run_id)
    tckpt.save_checkpoint(os.path.join(run.ckpt_dir, "last"), _payload(0))
    assert reg.get_ckpt_path(run.run_id, load_best=True).endswith("last")


def test_sigterm_interrupts_and_resumes(tmp_path):
    class Signaling(TorchFake):
        def train_epoch(self, epoch):
            if epoch == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            return super().train_epoch(epoch)

    before = signal.getsignal(signal.SIGTERM)
    reg = RunRegistry(str(tmp_path))
    run = reg.create_run("exp", {})
    task = Signaling([0.5, 0.6, 0.7, 0.8], "auc")
    tengine.fit(task, num_epochs=4, early=5, early_criterion="auc",
                registry=reg, run=run)
    assert task.script.evals == 2 and run.status == "INTERRUPTED"
    assert _value(os.path.join(run.ckpt_dir, "last")) == 1
    assert signal.getsignal(signal.SIGTERM) == before

    task2 = TorchFake([0.9], "auc")
    res = tengine.fit(task2, num_epochs=4, early=5, early_criterion="auc",
                      registry=reg, run=run, resume=True)
    assert task2.script.evals == 2 and task2.count == 4 * STEPS
    assert res["best"] == pytest.approx(0.9) and run.status == "RUNNING"


# ---- the PMGT task through the engine ----------------------------------

DATA = dict(num_nodes=150, num_users=40, feat_dims=(64, 32), avg_degree=6,
            interactions_per_user=3, seed=0)
EXTRA = dict(hidden_size=32, intermediate_size=32, num_hidden_layers=2)


@pytest.fixture(scope="module")
def art():
    return make_synthetic_dataset(**DATA)


@pytest.fixture
def deterministic():
    """Bit-for-bit runs: with several CPU threads a gradient reduction of
    the training step differs between identical runs by about 1e-7."""
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def _task(art, num_epochs):
    args = TrainArgs(seed=3, train_batch_size=16, test_batch_size=32,
                     num_epochs=num_epochs, early_criterion="auc", extra=dict(EXTRA))
    ctx = {"artifacts": art}
    init_dataloader(args, ctx)
    return PMGTTask(args, art, ctx["train_nodes"], ctx["valid_nodes"], device="cpu")


class _Recording:
    """Records each epoch's losses as the engine sees them."""

    def __init__(self, task):
        self.task, self.losses = task, []

    def __getattr__(self, name):
        return getattr(self.task, name)

    def train_epoch(self, epoch):
        out = self.task.train_epoch(epoch)
        self.losses.append(out.clone())
        return out


def test_two_epochs_and_a_resume_equal_three_straight(tmp_path, art, deterministic):
    reg = RunRegistry(str(tmp_path))
    straight = _Recording(_task(art, 3))
    straight_run = reg.create_run("exp", {})
    tengine.fit(straight, num_epochs=3, early=5, early_criterion="auc",
                registry=reg, run=straight_run)

    run = reg.create_run("exp", {})
    first = _Recording(_task(art, 2))
    tengine.fit(first, num_epochs=2, early=5, early_criterion="auc",
                registry=reg, run=run)
    resumed = _Recording(_task(art, 3))
    tengine.fit(resumed, num_epochs=3, early=5, early_criterion="auc",
                registry=reg, run=run, resume=True)

    assert len(resumed.losses) == 1
    for a, b in zip(first.losses + resumed.losses, straight.losses, strict=True):
        assert torch.equal(a, b)
    for (n, a), (_, b) in zip(resumed.task.model.named_parameters(),
                              straight.task.model.named_parameters()):
        assert torch.equal(a, b), n
    assert resumed.task.optimizer.count == straight.task.optimizer.count
    assert resumed.task._step_count == straight.task._step_count
    # the same metrics.jsonl rows, values included
    assert _rows(run) == _rows(straight_run)


def test_restoring_best_reproduces_its_logged_auc(tmp_path, art):
    reg = RunRegistry(str(tmp_path))
    run = reg.create_run("exp", {})
    task = _task(art, 3)
    tengine.fit(task, num_epochs=3, early=5, early_criterion="auc",
                registry=reg, run=run)
    best = tckpt.read_best_info(run.ckpt_dir)
    fresh = _task(art, 3)
    payload = tckpt.restore_checkpoint(reg.get_ckpt_path(run.run_id, load_best=True))
    fresh.model.load_state_dict(payload["state"]["model"])
    assert fresh.evaluate("valid")["val/auc"] == best["value"]
    logged = [m["value"] for m in run.metrics()
              if m["name"] == "val/auc" and m["epoch"] == best["epoch"]]
    assert logged == [best["value"]]
