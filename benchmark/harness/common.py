"""What every driver shares: seeds, the dataset as both sides get it, the
weights, the device's description and the checks' records."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from benchmark.yardstick import tgdata


def derive_seed(seed: int, stream: int) -> int:
    """A 31-bit seed for one stream (data, weights, program, traffic,
    sample) of the run's ``--seed``, whatever its size or sign."""
    ss = np.random.SeedSequence([int(seed) % 2**64, stream])
    return int(ss.generate_state(1)[0]) % 2**31


DATA, WEIGHTS, PROGRAM, TRAFFIC, SAMPLE = range(5)


def dataset(cfg: dict, seed: int) -> tgdata.RawDataset:
    """The configuration's dataset from the run's seed."""
    spec = cfg["dataset"]
    shape = tgdata.PUBLISHED_SHAPES[spec] if isinstance(spec, str) else spec
    return tgdata.make_dataset(shape, derive_seed(seed, DATA), float(cfg["signal"]),
                               feat_dims=tuple(cfg["feat_dims"]))


def program_artifacts(raw: tgdata.RawDataset):
    """The dataset in the program's containers: its graph builder over the
    raw edges, the feature tables and pairs as they are."""
    from pmgt_tpu_torch.data.artifacts import DatasetArtifacts
    from pmgt_tpu_torch.graph.container import from_edges

    edges = [(int(u), int(v), float(w)) for (u, v), w in zip(raw.edges.tolist(), raw.edge_weights)]
    return DatasetArtifacts(
        graph=from_edges(raw.num_nodes, edges), feat_init_embs=list(raw.feat_tables),
        train_pairs=raw.train_pairs, test_pairs=raw.test_pairs,
        num_users=raw.num_users, num_items=raw.num_nodes)


# ----------------------------------------------------------------------
# weights
# ----------------------------------------------------------------------

def encoder_shapes(cfg: dict, prefix: str = "bert.") -> List[Tuple[str, Tuple[int, ...]]]:
    h, i = cfg["hidden_size"], cfg["intermediate_size"]
    m = len(cfg["feat_dims"])
    out = []
    for k, f in enumerate(cfg["feat_dims"]):
        out += [(f"embeddings.feat_linear.{k}.weight", (h, f)), (f"embeddings.feat_linear.{k}.bias", (h,))]
    out += [("embeddings.modality_attention.weight", (m, m * h)), ("embeddings.modality_attention.bias", (m,)),
            ("embeddings.position_embeddings", (cfg["max_position_embeddings"], h)),
            ("embeddings.role_embeddings", (2, h)),
            ("embeddings.norm.weight", (h,)), ("embeddings.norm.bias", (h,))]
    for layer in range(cfg["num_hidden_layers"]):
        p = f"layers.{layer}."
        for n in ("query", "key", "value", "ctx_attention"):
            out += [(p + f"self_attention.{n}.weight", (h, h)), (p + f"self_attention.{n}.bias", (h,))]
        out += [(p + "attention_output.weight", (h, h)), (p + "attention_output.bias", (h,)),
                (p + "attention_norm.weight", (h,)), (p + "attention_norm.bias", (h,)),
                (p + "intermediate.weight", (i, h)), (p + "intermediate.bias", (i,)),
                (p + "output.weight", (h, i)), (p + "output.bias", (h,)),
                (p + "output_norm.weight", (h,)), (p + "output_norm.bias", (h,))]
    return [(prefix + n, s) for n, s in out]


def pretrain_shapes(cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    out = encoder_shapes(cfg)
    for k, f in enumerate(cfg["feat_dims"]):
        out += [(f"nfr_projections.{k}.weight", (f, cfg["hidden_size"])), (f"nfr_projections.{k}.bias", (f,))]
    return out


def pmgt_ncf_shapes(cfg: dict, num_users: int, num_items: int) -> List[Tuple[str, Tuple[int, ...]]]:
    from benchmark.yardstick.flops import tower_widths

    fn, nl = cfg["factor_num"], cfg["num_layers"]
    out = encoder_shapes(cfg) + [("mlp_user_embeddings.weight", (num_users, fn * 2 ** (nl - 1)))]
    widths = tower_widths(fn, nl, cfg["hidden_size"])
    for k, (a, b) in enumerate(widths):
        out += [(f"mlp_layers.{k}.weight", (b, a)), (f"mlp_layers.{k}.bias", (b,))]
    out += [("gmf_user_embeddings.weight", (num_users, fn)), ("gmf_item_embeddings.weight", (num_items, fn)),
            ("predict_layer.weight", (1, widths[-1][1] + fn)), ("predict_layer.bias", (1,))]
    return out


def _std(name: str, shape: Sequence[int], cfg: dict) -> Optional[float]:
    """The init's standard deviation, None for a constant (bias 0,
    LayerNorm scale 1): normal(initializer_range) for the encoder's
    kernels and embeddings, N(0, 0.01) for the NCF embeddings, Xavier's
    variance for the tower, LeCun's for the prediction layer."""
    if name.endswith("bias") or name.endswith("norm.weight"):
        return None
    if "embeddings.weight" in name and not name.startswith("bert."):
        return 0.01
    if name.startswith("mlp_layers."):
        return float(np.sqrt(2.0 / (shape[0] + shape[1])))
    if name.startswith("predict_layer."):
        return float(1.0 / np.sqrt(shape[1]))
    return float(cfg["initializer_range"])


def make_weights(shapes, cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """f32 weights on ``device`` from one normal draw of a generator on
    that device seeded from ``seed``, cut into the leaves in order."""
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, WEIGHTS))
    drawn = [(n, s) for n, s in shapes if _std(n, s, cfg) is not None]
    total = sum(int(np.prod(s)) for _, s in drawn)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for n, s in shapes:
        std = _std(n, s, cfg)
        if std is None:
            fill = 1.0 if n.endswith("norm.weight") else 0.0
            out[n] = torch.full(s, fill, device=device, dtype=torch.float32)
            continue
        k = int(np.prod(s))
        out[n] = (flat[at:at + k] * std).reshape(s)
        at += k
    return out


# ----------------------------------------------------------------------
# checks and leaf norms
# ----------------------------------------------------------------------

def check(name: str, value: float, limit: float) -> dict:
    """One number compared, beside its limit (pass: value <= limit)."""
    value = float(value)
    return {"name": name, "value": value, "limit": float(limit),
            "ok": bool(np.isfinite(value) and value <= limit)}


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             ref_grad: Dict[str, torch.Tensor]) -> float:
    """The worst leaf's gap between the norms of the program's and the
    reference's tensors, |‖a‖ − ‖b‖| / max(‖b‖, the median leaf's ‖b‖).
    Leaves whose reference gradient is under a thousandth of the median
    leaf's are left out (their updates are rounding, as a key's bias under
    softmax)."""
    gnorm = {n: float(torch.linalg.vector_norm(g.double())) for n, g in ref_grad.items()}
    gmed = float(np.median(list(gnorm.values())))
    names = [n for n in ref if gnorm[n] >= 1e-3 * gmed]
    rn = {n: float(torch.linalg.vector_norm(ref[n].double())) for n in names}
    med = float(np.median(list(rn.values())))
    worst = 0.0
    for n in names:
        pn = float(torch.linalg.vector_norm(prog[n].double()))
        gap = abs(pn - rn[n]) / max(rn[n], med, 1e-30) if np.isfinite(pn) else float("inf")
        worst = max(worst, gap)
    return worst


def first_gradient(adamw: torch.optim.Optimizer, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The gradient AdamW took at its first step, from its state: the first
    moment over (1 − β1); zero for a parameter it never updated."""
    st = adamw.state
    return {n: (st[p]["exp_avg"] / 0.1 if "exp_avg" in st.get(p, {}) else torch.zeros_like(p)).cpu()
            for n, p in params.items()}


def train_gaps(got: dict, ref: dict) -> dict:
    """A training cell's numbers: each checked step's loss against the
    reference's (relative, the worst step), the first gradient's worst
    leaf and the worst leaf of the parameters' change over the steps.
    ``got`` and ``ref`` hold "losses", "grad" and "params"; ``ref`` also
    "w0", the weights both started from."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
    grad_gap = leaf_gap(got["grad"], ref["grad"], ref["grad"])
    w0 = ref["w0"]
    update_gap = leaf_gap({n: got["params"][n] - w0[n] for n in w0},
                          {n: ref["params"][n] - w0[n] for n in w0}, ref["grad"])
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "update_gap": update_gap}


def snapshot(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The parameters' values now, on the host."""
    return {n: p.detach().cpu().clone() for n, p in params.items()}


def adam_state(adamw: torch.optim.Optimizer, params: Dict[str, torch.Tensor]) -> tuple:
    """(m, v, t), each {name: value} on the host: AdamW's moments and
    update counts as the run's optimizer holds them now."""
    m, v, t = {}, {}, {}
    for n, p in params.items():
        st = adamw.state.get(p, {})
        m[n] = st["exp_avg"].detach().cpu().clone() if "exp_avg" in st else torch.zeros_like(p, device="cpu")
        v[n] = st["exp_avg_sq"].detach().cpu().clone() if "exp_avg_sq" in st else torch.zeros_like(p, device="cpu")
        t[n] = int(st["step"]) if "step" in st else 0
    return m, v, t


def resume(tail: dict, cfg: dict, device) -> tuple:
    """(weights, optimizer) of the reference at the program's state before
    the step after the window."""
    from benchmark.reference import plain

    w = {n: t.to(device).clone() for n, t in tail["before"].items()}
    m, v, t = tail["moments"]
    opt = plain.AdamW(w, cfg["lr"], cfg["decay"], cfg["gradient_max_norm"],
                      state=({n: x.to(device) for n, x in m.items()},
                             {n: x.to(device) for n, x in v.items()}, t))
    return w, opt


def tail_of_program(tail: dict) -> dict:
    """The program's step after the window as the reference gives its own:
    the loss, the gradient the update took (from AdamW's first moment
    before and after it: (m₁ − β1·m₀) / (1 − β1)) and the weights after."""
    m0 = tail["moments"][0]
    return {"loss": tail["loss"], "after": tail["after"],
            "grad": {n: (tail["m_after"][n] - 0.9 * m0[n]) / 0.1 for n in m0}}


def tail_gaps(got: dict, ref: dict, before: Dict[str, torch.Tensor]) -> dict:
    """The step after the window, by the measures of ``train_gaps``: its
    loss, its gradient's worst leaf and its update's worst leaf, the
    update taken from the weights both started the step from."""
    return {"tail_loss_gap": abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
            "tail_grad_gap": leaf_gap(got["grad"], ref["grad"], ref["grad"]),
            "tail_update_gap": leaf_gap({n: got["after"][n] - before[n] for n in before},
                                        {n: ref["after"][n] - before[n] for n in before},
                                        ref["grad"])}


def unmoved(start: Dict[str, torch.Tensor], end: Dict[str, torch.Tensor],
            ref_grad: Dict[str, torch.Tensor]) -> int:
    """Leaves the reference moves (gradient at least a thousandth of the
    median leaf's, as in ``leaf_gap``) whose values did not change at all
    between ``start`` and ``end``."""
    gnorm = {n: float(torch.linalg.vector_norm(g.double())) for n, g in ref_grad.items()}
    gmed = float(np.median(list(gnorm.values())))
    return sum(1 for n in start if gnorm[n] >= 1e-3 * gmed and torch.equal(start[n], end[n]))


def mismatch(got: torch.Tensor, fed: torch.Tensor) -> int:
    """Lanes where the model's input differs from what the step was fed
    (all of them when the counts differ)."""
    if got.shape != fed.shape:
        return max(len(got), len(fed))
    return int((got.long() != fed.long()).sum())


def sync(device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def device_info(chips: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": int(chips),
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
