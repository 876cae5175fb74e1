"""Top-k serving of PMGT_NCF through ``PMGTNCFTask.serve_users``, as a
closed loop: a request is ``users_per_request`` users, scored against the
whole catalogue in tiles of ``item_chunk`` items by one scorer
(``task.scorer()``, built once, as a serving sweep builds it), training
positives excluded; the next request goes when the previous one's top-k
ids and scores are on the host.

Users come from the seed: ``"users": "permutation"`` walks one shuffled
order of all users (a sweep), ``"uniform"`` draws each request's users
independently (online traffic). The mix names its rate (``rate_metric``):
users whose top-k reached the host, per window second. A traced
sub-window counts its ``users`` for the same rate per layer.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.drivers import pmgt_ncf_common as pc
from benchmark.harness import common
from benchmark.harness.trace import span
from benchmark.reference import plain, sampler
from benchmark.yardstick import flops, peaks

WARM_REQUESTS = 2


class _Stream:
    """The seeded order of users, one request at a time."""

    def __init__(self, num_users: int, per_request: int, how: str, seed: int):
        self.rng = np.random.default_rng(common.derive_seed(seed, common.TRAFFIC))
        self.n, self.k, self.how, self.at = num_users, per_request, how, 0
        self.order = self.rng.permutation(num_users) if how == "permutation" else None

    def next(self) -> np.ndarray:
        if self.how == "uniform":
            return self.rng.integers(0, self.n, self.k)
        idx = (self.at + np.arange(self.k)) % self.n
        self.at = (self.at + self.k) % self.n
        return self.order[idx]


def setup(run) -> dict:
    state = pc.build(run)
    task, cfg, traffic = state["task"], state["cfg"], run.cell.traffic
    ctx_ids, ctx_mask = task.eval_ctx()
    state.update(
        score=task.scorer(), pos=torch.as_tensor(task.positives(), dtype=torch.int64,
                                                 device=run.device),
        eval_ctx=(ctx_ids.cpu(), ctx_mask.cpu()),
        stream=_Stream(state["raw"].num_users, int(traffic["users_per_request"]),
                       traffic["users"], run.seed),
        k=int(traffic["topk"]), chunk=int(traffic["item_chunk"]), served=[],
        users_per_request=int(traffic["users_per_request"]),
        rate_metric=traffic["rate_metric"])
    ni = state["raw"].num_nodes
    rows = len(torch.unique(ctx_ids[2:ni + 2]))
    state["request_flops"] = flops.serve_request_flops(cfg, state["users_per_request"], ni, rows)
    # each catalogue item's encoding is needed once a request, whoever asks
    state["kernel_work"] = peaks.attention_calls(cfg, ni, training=False)
    for _ in range(WARM_REQUESTS):
        _request(state, keep=False)
    return state


def _request(state, keep: bool = True):
    task = state["task"]
    users = torch.as_tensor(state["stream"].next(), dtype=torch.int64, device=state["device"])
    ids, scores = task.serve_users(state["score"], users, state["pos"][users], state["k"],
                                   state["chunk"])
    ids, scores = ids.cpu(), scores.cpu()  # the reply on the host
    if keep:
        state["served"].append((users.cpu(), ids, scores))


def window(state, seconds: float, tick=None) -> dict:
    """Requests until ``seconds`` have passed; ``tick()``, where given, is
    called between requests."""
    lat = []
    common.sync(state["device"])
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        _request(state)
        b = time.perf_counter()
        lat.append(b - a)
        if b - t0 >= seconds:
            break
        if tick is not None:
            tick()
    elapsed = time.perf_counter() - t0
    users = sum(len(u) for u, _, _ in state["served"])
    out = {state["rate_metric"]: users / elapsed,
           "serve_p95_ms": float(np.percentile(np.asarray(lat) * 1e3, 95))}
    return {"attempted": len(lat), "failed": 0, "window_s": elapsed, "metrics": out}


def traced(state, params: dict):
    n = int(params["trace_requests"])

    def run():
        for _ in range(n):
            with span("request"):
                _request(state)
        return n, {"kernel_work": state["kernel_work"], "flops": n * state["request_flops"],
                   "peak_flops": state["cfg"]["precision"],
                   "users": n * state["users_per_request"]}
    return run


def tail(state) -> None:
    """Nothing after the window: what it served is what the check judges."""


def release(state) -> None:
    for key in ("task", "score", "pos"):
        state.pop(key, None)


def sample_users(state, n: int):
    """(user, served ids, served scores) of ``n`` served users drawn from
    the seed."""
    rows = [(int(u), ids[j], sc[j]) for us, ids, sc in state["served"]
            for j, u in enumerate(us.tolist())]
    rng = np.random.default_rng(common.derive_seed(state["seed"], common.SAMPLE))
    pick = rng.choice(len(rows), size=min(n, len(rows)), replace=False)
    return [rows[i] for i in sorted(pick)]


def reference_scores(state, users, precision: str, dev) -> torch.Tensor:
    """[len(users), items] scores of every item for each user: each item
    encoded once over its evaluation context, the towers per pair,
    training positives at -inf."""
    cfg, raw = state["cfg"], state["raw"]
    plain.set_f32_matmul()
    ar = plain.Arith(precision)
    w = pc.reference_weights(state, dev)
    ni = raw.num_nodes
    ids = state["eval_ctx"][0][2:ni + 2].to(dev)
    mask = state["eval_ctx"][1][2:ni + 2].to(dev)
    enc = plain.Encoder(w, cfg, ar)
    with torch.no_grad():
        cls = torch.cat([enc(enc.project_rows(pc.feats(state, dev), ids[s:s + 2048]),
                             mask[s:s + 2048])[:, 0] for s in range(0, ni, 2048)])
        items = torch.arange(ni, device=dev)
        pos = pc.positives(state["train_pairs"])
        out = []
        for u in users:
            sc = plain.ncf_logits(w, cfg, ar, cls, torch.full((ni,), u, device=dev), items)
            seen = list(pos.get(u, ()))
            if seen:
                sc[torch.as_tensor(seen, device=dev)] = float("-inf")
            out.append(sc)
    return torch.stack(out)


def gaps(ref: torch.Tensor, ids: torch.Tensor, scores: torch.Tensor) -> dict:
    """Per user: how far each served item's reference score lies below
    the reference's score at that rank, and how far each served score
    lies from the reference's score of that item, both over the spread
    (standard deviation) of the user's reference scores; and the served
    slots that are wrong outright: an id out of range, a training
    positive, an id served twice, or an empty slot (score -inf) where the
    reference still had an item to serve."""
    ni, k = ref.shape[1], ids.shape[1]
    finite = torch.where(torch.isfinite(ref), ref, torch.nan)
    scale = torch.clamp(torch.from_numpy(np.nanstd(finite.cpu().numpy(), axis=1)).to(ref), min=1e-30)
    best = torch.sort(ref, dim=1, descending=True)[0][:, :k]
    served = torch.isfinite(scores)
    valid = (ids >= 0) & (ids < ni)
    got = torch.gather(ref, 1, torch.clamp(ids, 0, ni - 1))
    bad = int((served & ~valid).sum()) + int((served & valid & torch.isneginf(got)).sum())
    bad += int((~served & torch.isfinite(best)).sum())
    for row, ok in zip(ids, served):
        bad += int(ok.sum()) - len(torch.unique(row[ok]))
    both = served & torch.isfinite(got)
    rank_gap = torch.where(both & torch.isfinite(best), (best - got) / scale[:, None], 0.0)
    score_gap = torch.where(both, (scores - got).abs() / scale[:, None], 0.0)
    return {"bad_ids": bad, "rank_gap": float(rank_gap.max()), "score_gap": float(score_gap.max())}


def check(state) -> list:
    """A sample of the window's served users held to the plain
    reference; the evaluation contexts of every item held to the
    sampler's guarantees."""
    cfg, raw = state["cfg"], state["raw"]
    dev = state["device"]
    adj = sampler.adjacency(raw.num_nodes, raw.edges, dev)
    ni = raw.num_nodes
    ctx_bad = sampler.context_violations(adj, state["eval_ctx"][0][2:ni + 2],
                                         state["eval_ctx"][1][2:ni + 2],
                                         torch.arange(2, ni + 2), len(cfg["hop_sampling_sizes"]))
    rows = sample_users(state, int(cfg["check_users"]))
    users = [u for u, _, _ in rows]
    ref = reference_scores(state, users, "f32", dev)
    g = gaps(ref, torch.stack([r[1] for r in rows]).to(dev), torch.stack([r[2] for r in rows]).to(dev))
    limits = cfg["limits"]
    return [common.check("sampler_violations", ctx_bad, 0),
            common.check("bad_ids", g["bad_ids"], 0),
            common.check("rank_gap", g["rank_gap"], limits["rank_gap"]),
            common.check("score_gap", g["score_gap"], limits["score_gap"])]


def control(state, precision: str, dev) -> dict:
    """The reference in ``precision`` put in the program's place for the
    same sampled users: its own top-k against the f32 reference."""
    rows = sample_users(state, int(state["cfg"]["check_users"]))
    users = [u for u, _, _ in rows]
    ref = reference_scores(state, users, "f32", dev)
    low = reference_scores(state, users, precision, dev)
    k = state["k"]
    sc, ids = torch.sort(low, dim=1, descending=True, stable=True)
    return gaps(ref, ids[:, :k], sc[:, :k])
