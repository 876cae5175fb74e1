"""The training slice against the JAX package.

- ``_corrupt`` under JAX's own draws gives JAX's outputs exactly; with a
  generator its invariants hold (position 0 and padding untouched, ids in
  [2, N+2), replace and mask rates within binomial bounds).
- The GSR + NFR loss and every parameter's gradient against
  ``jax.value_and_grad`` of the Flax model (dropout probabilities 0,
  ``deterministic=False``, JAX's corruption draws), on both attention
  routes, weights through ``params_from_flax``: loss within 2e-5, each
  gradient within 1e-5 + 1e-4 * max|g|.
- AdamW, SGD, the clip and each schedule against optax over 5 steps in
  f64 (``jax.enable_x64`` scoped to the test); a decay mask made wrong on
  purpose must fail that comparison.
- The task: the epoch schedule equals the JAX task's, the training pair
  table is well formed, accumulation gives the mean of the micro-batch
  gradients, the two attention routes train alike, and a CPU task trains
  with finite losses.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pmgt_tpu.core.config import PMGTConfig as JPMGTConfig
from pmgt_tpu.models.pmgt import PMGTForPreTraining as JPMGT
from pmgt_tpu.sampling.pairs import PretrainBatch as JBatch
from pmgt_tpu.tasks import pmgt_task as jtask_mod
from pmgt_tpu.train import optim as joptim
from pmgt_tpu_torch.core.config import PMGTConfig, TrainArgs
from pmgt_tpu_torch.data.synthetic import make_synthetic_dataset
from pmgt_tpu_torch.models.interop import params_from_flax
from pmgt_tpu_torch.models.pmgt import PMGTForPreTraining
from pmgt_tpu_torch.sampling.pairs import PretrainBatch
from pmgt_tpu_torch.tasks.pmgt_task import PMGTTask, init_dataloader
from pmgt_tpu_torch.train import optim as toptim

NODE_SIZE = 60
FEAT_DIMS = (64, 32)
SEQ = 6
SMALL = dict(hidden_size=32, intermediate_size=48, num_hidden_layers=2,
             num_attention_heads=2, feat_hidden_sizes=FEAT_DIMS,
             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
RATIOS = dict(random_node_ratio=0.3, mask_node_ratio=0.4)


def _jbatch(arrays):
    return JBatch(*(jnp.asarray(a) for a in arrays))


def _tbatch(arrays):
    return PretrainBatch(*(
        torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32 else a)
        for a in arrays
    ))


def _sequences(rs, batch):
    ids = rs.integers(2, NODE_SIZE + 2, size=(batch, SEQ)).astype(np.int32)
    n_ctx = rs.integers(0, SEQ, size=batch)
    mask = (np.arange(SEQ)[None, :] <= n_ctx[:, None]).astype(np.float32)
    return np.where(mask > 0, ids, 0).astype(np.int32), mask


def _train_batch(rs, b, p):
    t_ids, t_mask = _sequences(rs, b)
    p_ids, p_mask = _sequences(rs, b * p)
    labels = (np.arange(p)[None, :] < rs.integers(0, 6, size=(b, 1))).astype(np.float32)
    valid = np.ones((b, p), np.float32)
    valid[0, -2:] = 0.0
    return (t_ids, t_mask, p_ids.reshape(b, p, SEQ), p_mask.reshape(b, p, SEQ),
            labels, valid)


@pytest.fixture(scope="module")
def setup():
    rs = np.random.default_rng(0)
    tables = [rs.standard_normal((NODE_SIZE + 2, f)).astype(np.float32)
              for f in FEAT_DIMS]
    for t in tables:
        t[:2] = 0.0
    jmodel = JPMGT(config=JPMGTConfig(**SMALL), node_size=NODE_SIZE, **RATIOS)
    dummy = _jbatch(_train_batch(np.random.default_rng(1), 2, 3))
    rngs = {k: jax.random.key(i) for i, k in
            enumerate(("params", "dropout", "corruption"))}
    params = jmodel.init(rngs, [jnp.asarray(t) for t in tables], dummy,
                         deterministic=False)["params"]
    return jmodel, jax.tree.map(np.asarray, params), tables


def _port_model(params, **overrides):
    model = PMGTForPreTraining(PMGTConfig(**{**SMALL, **overrides}), NODE_SIZE, **RATIOS)
    model.load_state_dict(params_from_flax(params), strict=True)
    return model


def _jax_corruption(jmodel, params, target_ids, key):
    """(JAX's _corrupt outputs, the draws it made), both from ``key``.
    ``make_rng`` in the top scope gives the key ``_corrupt`` splits."""
    variables = {"params": params}
    out = jmodel.apply(variables, jnp.asarray(target_ids),
                       method=JPMGT._corrupt, rngs={"corruption": key})
    rng = jmodel.apply(variables, method=lambda m: m.make_rng("corruption"),
                       rngs={"corruption": key})
    r_replace, r_ids, r_mask = jax.random.split(rng, 3)
    shape = (target_ids.shape[0], target_ids.shape[1] - 1)
    draws = (
        jax.random.uniform(r_replace, shape),
        jax.random.randint(r_ids, shape, minval=2, maxval=NODE_SIZE + 2,
                           dtype=jnp.int32),
        jax.random.uniform(r_mask, shape),
    )
    return [np.asarray(x) for x in out], [torch.from_numpy(np.array(x)) for x in draws]


def test_corrupt_matches_jax_under_its_draws(setup):
    jmodel, params, _ = setup
    ids, _ = _sequences(np.random.default_rng(4), 64)
    want, draws = _jax_corruption(jmodel, params, ids, jax.random.key(7))
    got = _port_model(params)._corrupt(torch.from_numpy(ids.astype(np.int64)),
                                       draws=draws)
    assert want[1].sum() > 0 and (want[2] != ids[:, 1:]).any()  # both fire
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), w)


def test_corrupt_invariants_with_a_generator(setup):
    _, params, _ = setup
    model = PMGTForPreTraining(PMGTConfig(**SMALL), NODE_SIZE)  # 0.02 / 0.16
    rs = np.random.default_rng(5)
    b = 20_000
    ids = rs.integers(2, NODE_SIZE + 2, size=(b, SEQ))
    ids[: b // 2, 4:] = 0  # padding in half the rows
    ids_t = torch.from_numpy(ids)
    masked_ids, pos_mask, targets = model._corrupt(
        ids_t, torch.Generator().manual_seed(0))
    ctx = ids[:, 1:]
    assert torch.equal(masked_ids[:, 0], ids_t[:, 0])
    pad = ctx == 0
    assert (masked_ids[:, 1:].numpy()[pad] == 0).all() and (targets.numpy()[pad] == 0).all()
    assert (pos_mask.numpy()[pad] == 0).all()
    real = targets.numpy()[~pad]
    assert real.min() >= 2 and real.max() < NODE_SIZE + 2
    m = pos_mask.numpy() > 0
    assert (masked_ids[:, 1:].numpy()[m] == 1).all()
    assert (masked_ids[:, 1:].numpy()[~m] == targets.numpy()[~m]).all()
    n = int((~pad).sum())
    for rate, hits in ((0.2 * 0.8, int(m.sum())),
                       (0.2 * 0.1, int((targets.numpy() != ctx)[~pad].sum()))):
        sd = (n * rate * (1 - rate)) ** 0.5
        # a replacement may draw the id it replaces: its rate is a bit lower
        lo = n * rate * (1 - 1 / NODE_SIZE if rate < 0.1 else 1) - 5 * sd
        assert lo <= hits <= n * rate + 5 * sd, (rate, hits, n)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_loss_and_gradients_match_flax(setup, impl):
    jmodel, params, tables = setup
    jm = jmodel.clone(config=dataclasses.replace(jmodel.config, attention_impl=impl))
    arrays = _train_batch(np.random.default_rng(6), 5, 10)
    key = jax.random.key(11)
    _, draws = _jax_corruption(jmodel, params, arrays[0], key)
    jt = [jnp.asarray(t) for t in tables]

    def loss_fn(p):
        out = jm.apply({"params": p}, jt, _jbatch(arrays), deterministic=False,
                       rngs={"corruption": key, "dropout": jax.random.key(3)})
        return out.loss, out

    (loss, out_j), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    assert float(out_j.nfr_loss) > 0.0

    model = _port_model(params, attention_impl=impl)
    out = model([torch.from_numpy(t) for t in tables], _tbatch(arrays),
                deterministic=False, compute_nfr=True,
                generator=torch.Generator().manual_seed(0), corruption=draws)
    out.loss.backward()
    for name in ("loss", "gsr_loss", "nfr_loss"):
        assert abs(getattr(out, name).item() - float(getattr(out_j, name))) <= 2e-5, name
    want = params_from_flax(jax.tree.map(np.asarray, grads))
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].grad
        tol = 1e-5 + 1e-4 * float(w.abs().max())
        err = float((g - w).abs().max())
        assert err <= tol, (name, err, tol)


# ---- optimizer --------------------------------------------------------

OPT_CASES = [
    dict(optim="adamw", scheduler_type=None, warmup_ratio=None, gradient_max_norm=None),
    dict(optim="adamw", scheduler_type="linear", warmup_ratio=0.4, gradient_max_norm=1.0),
    dict(optim="adamw", scheduler_type="cosine_with_restarts", warmup_ratio=None,
         gradient_max_norm=50.0),
    dict(optim="sgd", scheduler_type="cosine", warmup_ratio=None, gradient_max_norm=0.5),
]


def _run_both(params, case, steps=5):
    """Five updates with the same f32-representable gradients through
    optax (f64) and the port (f64). Returns (port params as f32 numpy,
    JAX params converted to the port's names)."""
    rs = np.random.default_rng(8)
    grads = [jax.tree.map(lambda x: rs.standard_normal(x.shape).astype(np.float32), params)
             for _ in range(steps)]
    kw = dict(lr=1e-2, decay=0.1, total_steps=steps, **case)
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), params)
        tx = joptim.make_optimizer(p64, **kw)
        state = tx.init(p64)
        for g in grads:
            g64 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), g)
            updates, state = tx.update(g64, state, p64)
            p64 = optax.apply_updates(p64, updates)
        want = params_from_flax(jax.tree.map(np.asarray, p64))

    model = _port_model(params).double()
    opt = toptim.make_optimizer(model, **kw)
    named = dict(model.named_parameters())
    for g in grads:
        for name, t in params_from_flax(g).items():
            named[name].grad = t.double()
        opt.step()
    assert opt.count == steps
    return {n: p.detach().float() for n, p in named.items()}, want


def _assert_params_close(got, want):
    for name, w in want.items():
        torch.testing.assert_close(got[name], w, rtol=1e-6, atol=1e-8, msg=name)


@pytest.mark.parametrize("case", OPT_CASES, ids=lambda c: f"{c['optim']}-{c['scheduler_type']}")
def test_optimizer_matches_optax(setup, case):
    _, params, _ = setup
    _assert_params_close(*_run_both(params, case))


def test_wrong_decay_mask_fails_the_comparison(setup, monkeypatch):
    _, params, _ = setup
    model = _port_model(params)
    mask = toptim.no_decay_mask(model)
    assert not mask["bert.layers.0.attention_norm.weight"]
    assert not mask["bert.layers.0.output.bias"]
    assert mask["bert.embeddings.position_embeddings"]
    assert mask["bert.embeddings.role_embeddings"]
    wrong = {n: (True if "norm" in n else v) for n, v in mask.items()}
    monkeypatch.setattr(toptim, "no_decay_mask", lambda m: wrong)
    with pytest.raises(AssertionError):
        _assert_params_close(*_run_both(params, OPT_CASES[0]))


@pytest.mark.parametrize("stype", [None, "constant", "constant_with_warmup", "linear",
                                   "cosine", "cosine_with_restarts", "polynomial"])
@pytest.mark.parametrize("warmup", [None, 0.25])
def test_schedules_match_optax(stype, warmup):
    total = 23
    ours = toptim.make_schedule(0.003, stype, total, warmup)
    with jax.enable_x64(True):
        theirs = joptim.make_schedule(0.003, stype, total, warmup)
        want = [float(theirs(jnp.asarray(t))) for t in range(total + 3)]
    got = [ours(t) for t in range(total + 3)]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
    if warmup:
        assert got[0] == 0.0


def test_clip_is_optax_clip_by_global_norm():
    g = [torch.tensor([3.0, 4.0], dtype=torch.float64), torch.tensor([12.0], dtype=torch.float64)]
    params = [torch.zeros_like(x, requires_grad=True) for x in g]
    for max_norm in (20.0, 13.0, 5.0):
        opt = toptim.Optimizer(torch.optim.SGD(params, lr=1.0), lambda t: 1.0, max_norm)
        for p, x in zip(params, g):
            p.grad = x.clone()
        opt.clip()
        with jax.enable_x64(True):
            want, _ = optax.clip_by_global_norm(max_norm).update(
                [jnp.asarray(x.numpy()) for x in g], optax.EmptyState())
        for p, w in zip(params, want):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-15)


# ---- the task ---------------------------------------------------------

DATA = dict(num_nodes=150, num_users=40, feat_dims=(64, 32), avg_degree=6,
            interactions_per_user=3, seed=0)
EXTRA = dict(hidden_size=32, intermediate_size=32, num_hidden_layers=2)


def _task(art, **kw):
    extra = {**EXTRA, **kw.pop("extra", {})}
    args = TrainArgs(seed=3, train_batch_size=16, test_batch_size=32, num_epochs=2,
                     extra=extra, **kw)
    ctx = {"artifacts": art}
    init_dataloader(args, ctx)
    return PMGTTask(args, art, ctx["train_nodes"], ctx["valid_nodes"], device="cpu")


@pytest.fixture(scope="module")
def art():
    return make_synthetic_dataset(**DATA)


@pytest.mark.parametrize("epoch", [0, 1, 7])
def test_epoch_schedule_matches_jax(art, epoch):
    task = _task(art)
    jself = SimpleNamespace(train_nodes=task.train_nodes.astype(np.int32),
                            args=SimpleNamespace(seed=task.args.seed))
    want = jtask_mod.PMGTTask._epoch_schedule(jself, epoch)
    np.testing.assert_array_equal(task._epoch_schedule(epoch), want)


def test_training_pair_table_is_well_formed(art):
    task = _task(art)
    ctx_ids, ctx_mask, (nodes, labels, valid) = task._get_ctx(("train", 0))
    assert task._get_ctx(("train", 0))[0] is ctx_ids  # cached
    n_total = task.sampling.num_total
    assert nodes.shape == labels.shape == valid.shape == (n_total, 10)
    assert ctx_ids.shape == (n_total, SEQ)
    g = art.graph
    deg = np.asarray(g.degrees)
    lab = labels.numpy()
    assert set(np.unique(lab)) <= {0.0, 1.0}
    assert (np.diff(lab, axis=1) <= 0).all()  # positives first
    np.testing.assert_array_equal(lab[2:].sum(1), np.minimum(deg[2:], 5))
    assert (valid.numpy()[:2] == 0).all() and (valid.numpy()[2:] == 1).all()
    nbr = np.asarray(g.nbr_ids)
    for r in range(2, n_total):
        nb = set(nbr[r, : deg[r]].tolist())
        row = nodes[r].numpy()
        assert all(x in nb for x in row[lab[r] > 0])
        negs = row[lab[r] == 0]
        # the non-neighbour set [2, N+2) (the target itself included)
        assert all(x not in nb and 2 <= x < n_total for x in negs)
    # a new epoch evicts the slot; eval draws stay
    task._get_ctx(("valid",))
    task.on_epoch_start(1)
    assert task._train_ctx_tag == ("train", 1) and ("valid",) in task._phase_ctx_cache


def test_accumulation_gives_the_mean_of_micro_batch_gradients(art):
    two = _task(art, accumulation_step=2)
    one = _task(art)
    one.model.load_state_dict(two.model.state_dict())
    targets = torch.as_tensor(two._epoch_schedule(0)[:16])
    two.accumulate_gradients(targets, torch.Generator().manual_seed(5))
    got = {n: p.grad.clone() for n, p in two.model.named_parameters()}
    gen = torch.Generator().manual_seed(5)  # the same stream, one micro-batch at a time
    parts = []
    for micro in targets.reshape(2, -1):
        one.accumulate_gradients(micro, gen)
        parts.append({n: p.grad.clone() for n, p in one.model.named_parameters()})
    for n, g in got.items():
        torch.testing.assert_close(g, (parts[0][n] + parts[1][n]) / 2, rtol=1e-5, atol=1e-7)


def test_task_trains_on_cpu(art):
    task = _task(art, gradient_max_norm=1.0, scheduler_type="linear", scheduler_warmup=0.2)
    before = {n: p.detach().clone() for n, p in task.model.named_parameters()}
    gens = list(task.train_batches(0))
    assert [g.initial_seed() for _, g in gens] == [
        (3 * 7_919 + i) % 2**32 for i in range(1, len(gens) + 1)]
    task.on_resume(0, 0)
    losses = task.train_epoch(0)
    steps = len(task.train_nodes) // 16
    assert losses.shape == (steps,) and bool(torch.isfinite(losses).all())
    assert task.optimizer.count == steps and task._step_count == steps
    changed = [n for n, p in task.model.named_parameters() if not torch.equal(p, before[n])]
    assert len(changed) == len(before)
    losses2 = task.train_epoch(1)
    assert losses2.shape == (steps,) and bool(torch.isfinite(losses2).all())
    out = task.evaluate("valid")
    assert 0.0 <= out["val/auc"] <= 1.0


def test_attention_routes_train_alike(art):
    """The kernel route (plain forward and backward on the CPU) and the
    plain batch-major route draw the same masks and take the same steps."""
    tasks = [_task(art, extra={"attention_impl": impl}) for impl in ("pallas", "xla")]
    tasks[1].model.load_state_dict(tasks[0].model.state_dict())
    losses = [t.train_epoch(0) for t in tasks]
    torch.testing.assert_close(losses[0], losses[1], rtol=1e-5, atol=1e-6)
    for (n, a), (_, b) in zip(tasks[0].model.named_parameters(),
                              tasks[1].model.named_parameters()):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5, msg=n)
