"""Each cell driven on the CPU at a tiny size, past the look for a card:
a sound run, then the timed path broken underneath in each way the cell
can break, and ``correct`` has to come out false. (On one card there is
no exchange between chips to leave out.)"""
from __future__ import annotations

import pytest
import torch

from benchmark.tests import tiny

TRAINING = ["pmgt-tg.pretrain", "pmgt_ncf-tg.train"]
SERVING = ["pmgt_ncf-tg.serve", "pmgt_ncf-tg.serve-1user"]


def correct(checks) -> bool:
    return all(c["ok"] for c in checks)


@pytest.fixture
def patch():
    undo = []

    def set_(obj, name, value):
        undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    yield set_
    for obj, name, value in reversed(undo):
        setattr(obj, name, value)


def test_sound_pretrain_run_is_correct():
    result, checks, _ = tiny.drive("pmgt-tg.pretrain", seconds=0.3)
    assert correct(checks), checks
    assert result["attempted"] > 0 and result["window_s"] > 0


def test_the_pretraining_window_runs_whole_epochs(patch):
    """The window ends at an epoch's end: each refresh's device work is
    spread over a whole epoch's steps, however many epochs fit."""
    from pmgt_tpu_torch.tasks.pmgt_task import PMGTTask

    per_epoch = []
    start, step = PMGTTask.on_epoch_start, PMGTTask.train_step

    def on_epoch_start(self, epoch):
        per_epoch.append(0)
        return start(self, epoch)

    def train_step(self, batch):
        per_epoch[-1] += 1
        return step(self, batch)

    patch(PMGTTask, "on_epoch_start", on_epoch_start)
    patch(PMGTTask, "train_step", train_step)
    result, checks, _ = tiny.drive("pmgt-tg.pretrain", seconds=0.05)
    assert correct(checks), checks
    window = per_epoch[1:-1]  # set-up's epoch 0 first, the tail's refresh and step last
    assert window and result["attempted"] == sum(window) == per_epoch[0] * len(window)
    assert per_epoch[-1] == 1


@pytest.mark.parametrize("cell", SERVING)
def test_sound_serving_run_is_correct(cell):
    result, checks, state = tiny.drive(cell, seconds=0.3)
    assert correct(checks), checks
    assert result["metrics"][state["rate_metric"]] > 0 and result["metrics"]["serve_p95_ms"] > 0


@pytest.mark.parametrize("cell", TRAINING)
def test_state_left_unchanged(cell, patch):
    from pmgt_tpu_torch.train import optim

    def step(self):  # the update is skipped, the count goes on
        self.count += 1

    patch(optim.Optimizer, "step", step)
    _, checks, _ = tiny.drive(cell, seconds=0.2)
    assert not correct(checks)
    assert {c["name"]: c for c in checks}["update_gap"]["value"] > 0.5


@pytest.mark.parametrize("cell", TRAINING)
def test_window_steps_leave_the_state_unchanged(cell, patch):
    """Set-up's steps are sound; every step from the window on skips its
    update: the step after the window and the leaves' movement over the
    window catch it."""
    from pmgt_tpu_torch.train import optim

    def step(self):
        self.count += 1

    _, checks, state = tiny.drive(cell, seconds=0.2,
                                  after_setup=lambda: patch(optim.Optimizer, "step", step))
    assert not correct(checks)
    assert state["readings"]["window_unmoved"] > 0
    assert state["readings"]["tail_update_gap"] > 0.5


def test_window_steps_take_a_wrong_gradient(patch):
    """From the window on, every update takes a tenth of its gradient (as a
    replayed step that read a stale buffer might): the step after the
    window is held to the reference and fails. (PMGT_NCF's gradient after
    the window is not compared: the bf16 program's worst leaf has no
    reading of a control or fault to set a limit against, and Adam's
    update does not see a gradient scaled alike in every step.)"""
    from pmgt_tpu_torch.train import optim

    orig = optim.Optimizer.step

    def tenth(self):
        for p in self.params:
            if p.grad is not None:
                p.grad.mul_(0.1)
        orig(self)

    _, checks, state = tiny.drive("pmgt-tg.pretrain", seconds=0.2,
                                  after_setup=lambda: patch(optim.Optimizer, "step", tenth))
    assert not correct(checks), state["readings"]


def test_refresh_skipped_in_the_window(patch):
    """Every epoch from the window on gets epoch 0's contexts and pairs
    again: the draws of the step after the window are stale."""
    from pmgt_tpu_torch.tasks.pmgt_task import PMGTTask

    orig = PMGTTask.on_epoch_start
    _, checks, state = tiny.drive(
        "pmgt-tg.pretrain", seconds=0.2,
        after_setup=lambda: patch(PMGTTask, "on_epoch_start", lambda self, e: orig(self, 0)))
    assert state["readings"]["stale_draws"] == 1.0
    assert not correct(checks)


def test_half_the_pretraining_batch(patch):
    from pmgt_tpu_torch.tasks.pmgt_task import PMGTTask

    orig = PMGTTask.accumulate_gradients

    def half(self, targets, generator):
        return orig(self, targets[: len(targets) // 2].repeat(2), generator)

    patch(PMGTTask, "accumulate_gradients", half)
    _, checks, _ = tiny.drive("pmgt-tg.pretrain", seconds=0.2)
    assert not correct(checks)


def test_half_the_training_batch(patch):
    from pmgt_tpu_torch.tasks.interaction_base import InteractionTaskBase

    orig = InteractionTaskBase.accumulate_gradients

    def half(self, batch):
        users, items, labels, gen = batch
        h = len(users) // 2
        return orig(self, (users[:h].repeat(2), items[:h].repeat(2), labels[:h].repeat(2), gen))

    patch(InteractionTaskBase, "accumulate_gradients", half)
    _, checks, _ = tiny.drive("pmgt_ncf-tg.train", seconds=0.2)
    assert not correct(checks)


@pytest.mark.parametrize("cell", SERVING)
@pytest.mark.parametrize("how", ["rank", "score"])
def test_answer_altered(cell, how, patch):
    from pmgt_tpu_torch.tasks.interaction_base import InteractionTaskBase

    orig = InteractionTaskBase.serve_users

    def altered(self, *args, **kwargs):
        ids, scores = orig(self, *args, **kwargs)
        ids, scores = ids.clone(), scores.clone()
        if how == "rank":  # the best item swapped for the 100th
            ids[:, [0, -1]] = ids[:, [-1, 0]]
        else:
            scores[:, 0] += 1.0
        return ids, scores

    patch(InteractionTaskBase, "serve_users", altered)
    _, checks, _ = tiny.drive(cell, seconds=0.2)
    assert not correct(checks)


@pytest.mark.parametrize("cell", TRAINING + SERVING)
def test_the_control_fails(cell):
    """The plain reference one precision below the configuration's (TF32
    for f32, stored fp8 for the bf16 policy), put in the program's place,
    reads above a limit (the chip runs of the control are the ones the
    limits come from; this keeps the path alive at a tiny size)."""
    from benchmark.harness import spec

    _, _, state = tiny.drive(cell, seconds=0.2)
    drv = spec.load_driver(tiny.tiny_cell(cell).traffic["driver"])
    got = drv.control(state, state["cfg"]["control_precision"], torch.device("cpu"))
    assert any(got[n] > limit for n, limit in state["cfg"]["limits"].items() if n in got), got
