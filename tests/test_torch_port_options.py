"""Per-step sampling (``--no-ctx-cache``) and the dynamic clip against the
JAX package.

- ``make_pretrain_batch`` under JAX's own draws (the three keys' uniforms
  and ranks) returns JAX's batch exactly; driven by three torch
  generators, the pair contexts' node marginals stay within TV < 5% of
  JAX's (the pattern of ``tests/test_sampler_parity.py``);
- a ``ctx_cache=False`` CPU epoch trains from fresh per-step draws (no
  training cache is drawn; three distinct streams a step);
- ``dynamic_clip_by_norm_history`` equals the optax transformation in
  scoped f64 (``jax.enable_x64``) over a sequence of gradients that clips
  and does not (both keep the norm window in f32: 1e-6 relative).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmgt_tpu.core.config import SamplingConfig as JSamplingConfig
from pmgt_tpu.graph.container import from_edges as j_from_edges
from pmgt_tpu.sampling import pairs as jpairs
from pmgt_tpu.utils.train import dynamic_clip_by_norm_history as jclip
from pmgt_tpu_torch.core.config import SamplingConfig, TrainArgs
from pmgt_tpu_torch.data.synthetic import make_synthetic_dataset
from pmgt_tpu_torch.graph.container import NUM_SPECIAL_NODES, PaddedGraph
from pmgt_tpu_torch.sampling.pairs import make_pretrain_batch
from pmgt_tpu_torch.tasks.pmgt_task import PMGTTask, init_dataloader
from pmgt_tpu_torch.utils.train import dynamic_clip_by_norm_history


def _random_edges(num_nodes, n_edges, seed):
    rs = np.random.RandomState(seed)
    edges, seen = [], set()
    for _ in range(n_edges):
        u, v = rs.randint(0, num_nodes, size=2)
        if u == v or (min(u, v), max(u, v)) in seen:
            continue
        seen.add((min(u, v), max(u, v)))
        edges.append((int(u), int(v), float(rs.uniform(0.5, 2.0))))
    return edges


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    jg = j_from_edges(90, _random_edges(90, 300, seed=7))
    path = str(tmp_path_factory.mktemp("g") / "graph.npz")
    jg.save(path)
    return jg, PaddedGraph.load(path)


def _hop_uniforms(key, batch, hops):
    draws, f = [], 1
    for k, num in zip(jax.random.split(key, len(hops)), hops):
        draws.append(np.array(jax.random.uniform(k, (batch, f, num))))
        f *= num
    return draws


@pytest.mark.parametrize("is_training", [True, False])
def test_make_pretrain_batch_exact_under_jax_draws(graphs, is_training):
    jg, tg = graphs
    hops = (6, 4, 2)
    cfg_j = JSamplingConfig(hop_sampling_sizes=hops, num_total=jg.num_total)
    cfg_t = SamplingConfig(hop_sampling_sizes=hops, num_total=tg.num_total)
    targets = np.arange(NUM_SPECIAL_NODES, jg.num_total, 3, dtype=np.int32)
    key = jax.random.key(11)
    want = jpairs.make_pretrain_batch(jg, jnp.asarray(targets), key, cfg_j, is_training)

    # the draws of make_pretrain_batch (pairs.py:195-231) and sample_pairs
    key_ctx, key_pairs, key_pair_ctx = jax.random.split(key, 3)
    b, d = len(targets), jg.max_degree
    total = cfg_j.max_total_samples if is_training else 2
    key_pos, key_neg = jax.random.split(key_pairs)
    comp = jg.num_total - NUM_SPECIAL_NODES - jg.degrees[targets][:, None]
    rank = np.array(jax.random.randint(key_neg, (b, total), 0,
                                       jnp.maximum(jnp.asarray(comp), 1), dtype=jnp.int32))
    draws = (_hop_uniforms(key_ctx, b, hops),
             (torch.from_numpy(np.array(jax.random.uniform(key_pos, (b, d)))),
              torch.from_numpy(rank)),
             _hop_uniforms(key_pair_ctx, b * total, hops))
    got = make_pretrain_batch(tg.to("cpu"), torch.from_numpy(targets), cfg_t, is_training,
                              draws=draws)
    for name in got._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)


def _pair_ctx_marginals(batch, num_total):
    ids = np.asarray(batch.pair_ids)[..., 1:].reshape(-1)
    mask = np.asarray(batch.pair_mask)[..., 1:].reshape(-1) > 0
    counts = np.bincount(ids[mask], minlength=num_total).astype(np.float64)
    return counts / counts.sum()


def test_generator_batches_match_jax_in_distribution(graphs):
    jg, tg = graphs
    hops = (6, 4, 2)
    cfg_j = JSamplingConfig(hop_sampling_sizes=hops, num_total=jg.num_total)
    cfg_t = SamplingConfig(hop_sampling_sizes=hops, num_total=tg.num_total)
    targets = np.full(3000, 5, np.int32)
    want = jax.jit(lambda t, k: jpairs.make_pretrain_batch(jg, t, k, cfg_j, True))(
        jnp.asarray(targets), jax.random.key(0))
    gens = [torch.Generator().manual_seed(s) for s in (1, 2, 3)]
    got = make_pretrain_batch(tg.to("cpu"), torch.from_numpy(targets), cfg_t, True,
                              generators=gens)
    jm = _pair_ctx_marginals(want, jg.num_total)
    tm = _pair_ctx_marginals(got, tg.num_total)
    tv = 0.5 * np.abs(tm - jm).sum()
    assert tv < 0.05, f"TV distance {tv:.3f}"
    # and the labels: the same positive count per target
    np.testing.assert_array_equal(got.labels.sum(1).numpy(), np.asarray(want.labels).sum(1))
    with pytest.raises(ValueError, match="three generators"):
        make_pretrain_batch(tg.to("cpu"), torch.from_numpy(targets[:4]), cfg_t, True,
                            generators=gens[:2])


def test_no_ctx_cache_epoch_trains_on_cpu():
    art = make_synthetic_dataset(num_nodes=150, num_users=40, feat_dims=(64, 32),
                                 avg_degree=6, interactions_per_user=3, seed=0)
    args = TrainArgs(seed=3, train_batch_size=16, test_batch_size=32, num_epochs=1,
                     extra=dict(hidden_size=32, intermediate_size=32, num_hidden_layers=2,
                                ctx_cache=False))
    ctx = {"artifacts": art}
    init_dataloader(args, ctx)
    task = PMGTTask(args, art, ctx["train_nodes"], ctx["valid_nodes"], device="cpu")
    before = {n: p.detach().clone() for n, p in task.model.named_parameters()}
    (_, gen), = list(task.train_batches(0))[:1]
    seeds = [g.initial_seed() for g in task.sampling_generators(gen)]
    assert len(set(seeds)) == 3 and gen.initial_seed() not in seeds
    task.on_resume(0, 0)
    losses = task.train_epoch(0)
    assert task._train_ctx is None  # no per-epoch draw
    assert len(losses) == len(task.train_nodes) // 16 and bool(torch.isfinite(losses).all())
    assert all(not torch.equal(p, before[n]) for n, p in task.model.named_parameters())
    out = task.evaluate("valid")
    assert 0.0 <= out["val/auc"] <= 1.0 and ("valid",) in task._phase_ctx_cache


def test_dynamic_clip_matches_optax_in_f64():
    rs = np.random.default_rng(0)
    shapes = [(3, 4), (5,), (2, 2, 2)]
    scales = [1.0, 1.1, 0.9, 5.0, 1.0, 0.2, 8.0, 1.0, 1.0, 3.0, 0.5, 1.0, 20.0]
    grads = [[rs.standard_normal(s) * c for s in shapes] for c in scales]
    with jax.enable_x64(True):
        tx = jclip(window=4, clip_factor=1.5, eps=1e-2)
        state = tx.init(None)
        want = []
        for g in grads:
            out, state = tx.update([jnp.asarray(x, jnp.float64) for x in g], state)
            want.append([np.asarray(x) for x in out])
        want_norms = np.asarray(state.norms)
    clip = dynamic_clip_by_norm_history(window=4, clip_factor=1.5, eps=1e-2)
    tstate = clip.init()
    clipped_steps = 0
    for g, w in zip(grads, want, strict=True):
        out, tstate = clip.update([torch.from_numpy(x) for x in g], tstate)
        for a, b in zip(out, w, strict=True):
            assert a.dtype == torch.float64
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-12)
        clipped_steps += not np.allclose(out[0].numpy(), g[0])
    assert 0 < clipped_steps < len(grads)
    assert int(tstate.count) == 4 and int(tstate.pos) == len(grads) % 4
    np.testing.assert_allclose(tstate.norms.numpy(), want_norms, rtol=1e-6)
