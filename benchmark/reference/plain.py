"""The plain reference of PMGT and PMGT_NCF: float32 PyTorch, batch-major,
one formula after another, with no kernel, cache or fused path, and
nothing imported from the program.

It follows the published description (arXiv:2010.12284 §3; reference
``pmgt/models.py``) as the port states it:
- embeddings: each modality's rows projected to H, softmax attention over
  the modalities (scores from tanh of their concatenation), the position
  and role embeddings added, LayerNorm, dropout;
- layers: dual attention ``(β·softmax(1 − cos(c, c) + I + M) + (1 −
  β)·softmax(q·kᵀ/√d + M))·v`` with attention dropout on each
  distribution, the output projection, dropout, post-LN residual, the
  exact-erf GELU FFN, dropout, post-LN residual;
- GSR: BCE of the cosine of target and pair CLS states, mean over each
  target's valid pairs, then over targets; NFR: squared error of the
  masked slots' projections against their feature rows, mean over masked
  slots and widths, then over modalities;
- PMGT_NCF (NeuMF-end): [user MLP embedding ; item CLS] through the ReLU
  tower, the GMF product beside it, one prediction layer;
- AdamW (β 0.9, 0.999, ε 1e-8, decay on every weight but biases and
  LayerNorm scales) behind an optional global-norm clip.

The weights are a dict {name: tensor} that the benchmark made; the names
are the program's parameter names, so one dict serves both sides.

Randomness: a training step's dropout and NFR corruption are drawn from a
generator seeded with the step's seed, in the order and shapes the port
documents (``Draws``), so both sides see one pattern.

``precision`` selects the control's arithmetic: ``"f32"`` (float32, TF32
off), ``"tf32"`` (every matrix product's operands rounded to TF32's
10-bit mantissa, f32 sums, as the tensor cores take them) or ``"fp8"``
(every product's operands scaled per tensor to e4m3's range and rounded
to float8_e4m3fn); ``"fp8_act"`` as ``"fp8"`` with every intermediate the
encoder and the towers store (each projection, LayerNorm, GELU, softmax and
residual output) rounded to e4m3 too: the bf16 policy of the program one
step lower.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

NUM_SPECIAL_NODES = 2
F32_MIN = torch.finfo(torch.float32).min


def set_f32_matmul() -> None:
    """Float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "f32":
        return x
    if precision == "tf32":
        bits = x.contiguous().view(torch.int32)
        # round to nearest on the 13 dropped mantissa bits
        bits = (bits + 0x1000) & ~0x1FFF
        return bits.view(torch.float32)
    if precision in ("fp8", "fp8_act"):
        amax = torch.clamp(x.abs().amax(), min=1e-30)
        scale = 448.0 / amax
        return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    raise ValueError(f"unknown precision {precision!r}")


class _RoundedMatmul(torch.autograd.Function):
    """a @ b with the operands of the product and of both backward products
    rounded to ``precision``, sums in f32."""

    @staticmethod
    def forward(ctx, a, b, precision):
        ctx.save_for_backward(a, b)
        ctx.precision = precision
        return _round(a, precision) @ _round(b, precision)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        p = ctx.precision
        ar, br, gr = _round(a, p), _round(b, p), _round(g, p)
        ga = (gr @ br.transpose(-1, -2)).sum_to_size(a.shape)
        gb = (ar.transpose(-1, -2) @ gr).sum_to_size(b.shape)
        return ga, gb, None


class Arith:
    """Matrix products in the chosen precision."""

    def __init__(self, precision: str = "f32"):
        self.precision = precision

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "f32":
            return a @ b
        return _RoundedMatmul.apply(a, b, self.precision)

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """An intermediate as it is stored: rounded to fp8 under
        ``"fp8_act"``, as a bf16 policy stores each in bf16, its gradient
        passed on unrounded (the backward products round their operands);
        as it is otherwise."""
        if self.precision != "fp8_act":
            return x
        return x + (_round(x.detach(), "fp8") - x.detach())  # the gradient passes as scaled fp8 does

    def linear(self, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
        y = self.matmul(x, w.t())
        return y if b is None else y + b


class Draws:
    """A step's random draws, in the program's documented order, from a
    generator seeded with the step's seed on ``device``."""

    def __init__(self, seed: int, device):
        self.gen = torch.Generator(device=device).manual_seed(int(seed))
        self.device = device

    def rand(self, shape) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.gen, device=self.device,
                          dtype=torch.float32)

    def randint(self, low: int, high: int, shape) -> torch.Tensor:
        return torch.randint(low, high, tuple(shape), generator=self.gen, device=self.device)


def layer_norm(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def dual_attention(ar: Arith, q, k, v, c, key_mask, beta, m1=None, m2=None, keep=1.0):
    """q, k, v, c [N, S, d]; key_mask [N, S] (1 real, 0 padded); m1, m2
    [N, S, S] keep masks or None → [N, S, d]."""
    s, d = q.shape[1], q.shape[2]
    add = ((1.0 - key_mask) * F32_MIN)[:, None, :]
    norm = torch.sqrt(torch.sum(c * c, dim=-1, keepdim=True))
    cos = ar.matmul(c, c.transpose(1, 2)) / torch.clamp(norm * norm.transpose(1, 2), min=1e-12)
    eye = torch.eye(s, device=q.device, dtype=q.dtype)
    p1 = ar.act(torch.softmax(1.0 - cos + eye + add, dim=-1))
    p2 = ar.act(torch.softmax(ar.matmul(q, k.transpose(1, 2)) / math.sqrt(d) + add, dim=-1))
    if m1 is not None:
        p1 = torch.where(m1, p1 / keep, torch.zeros((), device=q.device))
        p2 = torch.where(m2, p2 / keep, torch.zeros((), device=q.device))
    return ar.matmul(beta * p1 + (1.0 - beta) * p2, v)


class Encoder:
    """The PMGT encoder over raw feature tables, parameters under
    ``prefix`` (``"bert."``) of ``w``."""

    def __init__(self, w: Dict[str, torch.Tensor], cfg: dict, ar: Arith, prefix: str = "bert."):
        self.w, self.cfg, self.ar, self.p = w, cfg, ar, prefix

    def _lin(self, name, x):
        return self.ar.act(self.ar.linear(x, self.w[self.p + name + ".weight"],
                                          self.w[self.p + name + ".bias"]))

    def project_rows(self, feats: Sequence[torch.Tensor], ids: torch.Tensor) -> List[torch.Tensor]:
        """Each modality's projected rows of ``ids`` (any shape) → [..., H]."""
        return [self._lin(f"embeddings.feat_linear.{m}", t[ids]) for m, t in enumerate(feats)]

    def __call__(self, proj: Sequence[torch.Tensor], key_mask: torch.Tensor,
                 draws: Optional[Draws] = None) -> torch.Tensor:
        """proj: per modality [L, S, H]; key_mask [L, S] → hidden [L, S, H].
        With ``draws`` the dropout of training."""
        cfg, w, ar = self.cfg, self.w, self.ar
        hid, heads = cfg["hidden_size"], cfg["num_attention_heads"]
        d = hid // heads
        rate = cfg["hidden_dropout_prob"]
        arate = cfg["attention_probs_dropout_prob"]
        eps = cfg["layer_norm_eps"]
        lanes, s = key_mask.shape
        concat = torch.cat(list(proj), dim=-1)
        scores = torch.softmax(self._lin("embeddings.modality_attention", torch.tanh(concat)), dim=-1)
        fused = torch.sum(scores[..., None] * torch.stack(list(proj), dim=2), dim=2)
        role = torch.ones(s, dtype=torch.int64, device=key_mask.device)
        role[0] = 0
        x = fused + w[self.p + "embeddings.position_embeddings"][:s][None] \
            + w[self.p + "embeddings.role_embeddings"][role][None]
        x = ar.act(layer_norm(x, w[self.p + "embeddings.norm.weight"],
                              w[self.p + "embeddings.norm.bias"], eps))
        if draws is not None:
            x = torch.where(draws.rand(x.shape) < 1.0 - rate, x / (1.0 - rate), x.new_zeros(()))
        keep = 1.0 - arate
        for i in range(cfg["num_hidden_layers"]):
            pre = f"layers.{i}."

            def heads_of(t):  # [L, S, H] -> [L*h, S, d]
                return t.reshape(lanes, s, heads, d).permute(0, 2, 1, 3).reshape(lanes * heads, s, d)

            q, k, v, c = (heads_of(self._lin(pre + "self_attention." + n, x))
                          for n in ("query", "key", "value", "ctx_attention"))
            m1 = m2 = None
            if draws is not None:
                # [S, L*h, S] seq-major, as drawn -> [L*h, S, S]
                m1 = (draws.rand((s, lanes * heads, s)) < keep).transpose(0, 1)
                m2 = (draws.rand((s, lanes * heads, s)) < keep).transpose(0, 1)
            km = key_mask.repeat_interleave(heads, dim=0)
            att = ar.act(dual_attention(ar, q, k, v, c, km, cfg["beta"], m1, m2, keep))
            att = att.reshape(lanes, heads, s, d).permute(0, 2, 1, 3).reshape(lanes, s, hid)
            att = self._lin(pre + "attention_output", att)
            if draws is not None:
                m = draws.rand((s, lanes, hid)).transpose(0, 1) < 1.0 - rate
                att = torch.where(m, att / (1.0 - rate), att.new_zeros(()))
            x = ar.act(layer_norm(att + x, w[self.p + pre + "attention_norm.weight"],
                                  w[self.p + pre + "attention_norm.bias"], eps))
            out = self._lin(pre + "output", ar.act(gelu(self._lin(pre + "intermediate", x))))
            if draws is not None:
                m = draws.rand((s, lanes, hid)).transpose(0, 1) < 1.0 - rate
                out = torch.where(m, out / (1.0 - rate), out.new_zeros(()))
            x = ar.act(layer_norm(out + x, w[self.p + pre + "output_norm.weight"],
                                  w[self.p + pre + "output_norm.bias"], eps))
        return x


def bce(logits, labels):
    return torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-torch.abs(logits)))


def pretrain_loss(w, cfg, ar: Arith, feats, num_nodes: int, batch: dict, draws: Draws):
    """PMGT's GSR + NFR loss of one step. ``batch``: target_ids [B, S],
    target_mask [B, S], pair_ids [B, P, S], pair_mask [B, P, S], labels
    [B, P], pair_valid [B, P] (float tensors where masks)."""
    tid, tmask = batch["target_ids"], batch["target_mask"]
    b, p, s = batch["pair_ids"].shape
    ctx = tid[:, 1:]
    rand1 = draws.rand(ctx.shape)
    random_ids = draws.randint(NUM_SPECIAL_NODES, num_nodes + NUM_SPECIAL_NODES, ctx.shape)
    rand2 = draws.rand(ctx.shape)
    replace = (rand1 < cfg["random_node_ratio"]) & (ctx != 0)
    replaced = torch.where(replace, random_ids, ctx)
    masked = (rand2 < cfg["mask_node_ratio"]) & (replaced != 0)
    masked_ids = torch.cat([tid[:, :1], torch.where(masked, torch.ones_like(replaced), replaced)], 1)
    ids = torch.cat([tid, batch["pair_ids"].reshape(b * p, s), masked_ids])
    key_mask = torch.cat([tmask, batch["pair_mask"].reshape(b * p, s), tmask])
    enc = Encoder(w, cfg, ar)
    hidden = enc(enc.project_rows(feats, ids), key_mask, draws)
    t = hidden[:b, 0]
    pc = hidden[b:b + b * p, 0].reshape(b, p, -1)
    t = t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=1e-12)
    pc = pc / torch.clamp(torch.linalg.norm(pc, dim=-1, keepdim=True), min=1e-12)
    logits = torch.sum(t[:, None, :] * pc, dim=-1)
    valid = batch["pair_valid"]
    counts = valid.sum(1)
    per_sample = (bce(logits, batch["labels"]) * valid).sum(1) / torch.clamp(counts, min=1.0)
    sample_ok = (counts > 0).float()
    gsr = (per_sample * sample_ok).sum() / torch.clamp(sample_ok.sum(), min=1.0)
    pos = masked.float()
    count = pos.sum()
    ctx_hidden = hidden[b + b * p:, 1:]
    losses = []
    for m, table in enumerate(feats):
        pred = ar.linear(ctx_hidden, w[f"nfr_projections.{m}.weight"], w[f"nfr_projections.{m}.bias"])
        sq = torch.sum((pred - table[replaced]) ** 2, dim=-1)
        losses.append(torch.sum(sq * pos) / torch.clamp(count * pred.shape[-1], min=1.0))
    return gsr + torch.stack(losses).mean()


def ncf_logits(w, cfg, ar: Arith, cls: torch.Tensor, users: torch.Tensor, items: torch.Tensor):
    """PMGT_NCF NeuMF-end logits of (users[i], items[i]) given each pair's
    item CLS state ``cls`` [P, H]."""
    x = torch.cat([w["mlp_user_embeddings.weight"][users], cls], dim=-1)
    for i in range(cfg["num_layers"]):
        x = ar.act(torch.relu(ar.linear(x, w[f"mlp_layers.{i}.weight"], w[f"mlp_layers.{i}.bias"])))
    gmf = w["gmf_user_embeddings.weight"][users] * w["gmf_item_embeddings.weight"][items]
    return ar.linear(torch.cat([gmf, x], dim=-1), w["predict_layer.weight"],
                     w["predict_layer.bias"])[:, 0]


def pmgt_ncf_logits(w, cfg, ar: Arith, feats, batch: dict, draws: Draws):
    """(logits [B], the items' CLS states [B, H]) of one PMGT_NCF training
    step (its loss is the logits' mean BCE): ``batch`` users [B], items
    [B], seq_ids [B, S] and seq_mask [B, S] (each item's context)."""
    enc = Encoder(w, cfg, ar)
    cls = enc(enc.project_rows(feats, batch["seq_ids"]), batch["seq_mask"], draws)[:, 0]
    return ncf_logits(w, cfg, ar, cls, batch["users"], batch["items"]), cls


def decays(name: str) -> bool:
    """AdamW's decay mask: every weight but biases and LayerNorm scales."""
    return not (name.endswith("bias") or name.endswith("norm.weight"))


class AdamW:
    """torch's AdamW update, written out, behind optax's global-norm clip.
    ``state``, where given, is (m, v, t), each {name: value}: the moments
    and update counts to go on from, as a run's optimizer holds them."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, decay: float,
                 max_norm: Optional[float] = None, state=None):
        self.lr, self.decay, self.max_norm = lr, decay, max_norm
        if state is None:
            state = ({n: torch.zeros_like(p) for n, p in params.items()},
                     {n: torch.zeros_like(p) for n, p in params.items()}, dict.fromkeys(params, 0))
        self.m, self.v, self.t = ({n: x.clone() for n, x in state[0].items()},
                                  {n: x.clone() for n, x in state[1].items()}, dict(state[2]))

    @torch.no_grad()
    def clipped(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The gradients as the update takes them: g·max_norm/|g| where the
        global norm |g| reaches ``max_norm``."""
        if self.max_norm is None:
            return grads
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        if norm < self.max_norm:
            return grads
        return {n: g / norm * self.max_norm for n, g in grads.items()}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        """One update with gradients already ``clipped``."""
        b1, b2, eps = 0.9, 0.999, 1e-8
        for n, p in params.items():
            self.t[n] += 1
            c1, c2 = 1 - b1 ** self.t[n], 1 - b2 ** self.t[n]
            g = grads[n]
            if self.decay and decays(n):
                p.mul_(1 - self.lr * self.decay)
            self.m[n].mul_(b1).add_(g, alpha=1 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = self.v[n].sqrt() / math.sqrt(c2) + eps
            p.addcdiv_(self.m[n], denom, value=-self.lr / c1)
