"""PMGT encoder and pretraining model (counterpart of
``pmgt_tpu/models/pmgt.py``).

The residual stream runs seq-major [S, B, H] through the layers, as in the
JAX package, so the dual-attention kernel reads position slices of the
flat [S*B, H] projection outputs without a relayout. Public inputs and
outputs stay batch-major [B, S, H].

``config.attention_impl`` picks the attention route: ``"pallas"`` goes
through ``ops.dual_attention.dual_attention_sm`` (the hand-written CUDA
kernel on a GPU, its plain version on the CPU); ``"xla"`` runs the plain
batch-major formulation ``dual_attention_plain``. As in the JAX package, a
layer with relative positions, a ``head_mask`` or ``output_attentions``
takes the plain formulation on either route: the kernels cover the
absolute-position attention only.

``config.dtype`` is the compute policy. Parameters stay float32; under
``"bfloat16"`` every dense layer casts its input, kernel and bias to bf16
(flax's ``Dense(dtype=...)``), the position, role and distance embeddings
and the additive mask (``finfo(bf16).min``) are bf16, and the stream, the
attention and the heads run in bf16. LayerNorm is flax's: statistics in
f32 by E[x²] - E[x]², the normalisation in f32, the output in bf16;
softmax and GELU round their steps as JAX's bf16 evaluation does. The
attention kernels take bf16 q/k/v/c and compute in f32. The GSR loss is
f32 (its labels promote it) and NFR accumulates each row's squared error
in f32. Gradients reach the f32 parameters in f32.

``config.gradient_checkpointing`` recomputes each layer in the backward
(``torch.utils.checkpoint``, non-reentrant). The recompute replays the
layer's dropout draws from a generator restored to the state the layer
entered with, so it sees the first pass's masks, and the caller's
generator leaves the layer where a forward without checkpointing leaves
it.

Training (``deterministic=False``) needs a ``torch.Generator`` on the
model's device; there is no global RNG and no ``nn.Dropout``. One forward
draws, in this order: the NFR corruption (``_corrupt``: replace uniforms,
random ids, mask uniforms), then the embeddings' dropout mask, then per
layer the attention keep masks m1 and m2 (``draw_keep_masks``, one pair
for both attention routes), the ``attention_output`` dropout mask and the
``output`` dropout mask. Dropout is flax's: ``where(u < keep, x / keep,
0)``.

Data parallelism (``forward(..., mesh=)``, a rank of ``core/mesh``): the
rank's batch is its contiguous share of the global micro-batch, so its
lanes are three index ranges of the global lane layout ``[targets | pairs
| masked]``. Every draw is made in the global micro-batch's shape from the
step's generator and the rank keeps its lanes (``core/mesh.lane_draws``:
the corruption on the target rows, the hidden dropout on the lane axis,
the keep masks on axis 1), so N ranks draw what one process draws. The
GSR and NFR denominators (valid samples, masked slots) are summed over the
ranks before dividing: each rank's loss is its numerator over the global
denominator, and the ranks' losses and gradients add up to the global
ones. With row-sharded feature tables every row read goes through
``core/quant.tables_rows``; under ``project_tables`` each rank projects its
own rows and gathers the projected rows, with their gradient.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from pmgt_tpu_torch.core.config import PMGTConfig
from pmgt_tpu_torch.core.mesh import Mesh, ShardedDraws, all_reduce, lane_draws, rand, randint
from pmgt_tpu_torch.core.quant import ShardedTable, dense_table, tables_rows
from pmgt_tpu_torch.graph.container import NUM_SPECIAL_NODES
from pmgt_tpu_torch.ops.dual_attention import draw_keep_masks, dual_attention_sm
from pmgt_tpu_torch.sampling.pairs import PretrainBatch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
RELATIVE_POSITIONS = ("relative_key", "relative_key_query")
_SQRT_HALF_BF16 = float(torch.tensor(0.5**0.5, dtype=torch.bfloat16))


def compute_dtype(cfg: PMGTConfig) -> torch.dtype:
    """The torch dtype of ``cfg.dtype`` (float32 or bfloat16)."""
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"compute dtype must be float32 or bfloat16, got {cfg.dtype!r}")
    return _DTYPES[cfg.dtype]


def _additive_mask(attention_mask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(1 - mask) * finfo(dtype).min — HF's extended attention mask."""
    big_neg = torch.finfo(dtype).min
    return ((1.0 - attention_mask) * big_neg).to(dtype)


def linear(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=dtype)``: input, kernel and bias cast to
    ``dtype`` (the parameters stay float32)."""
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``LayerNorm(dtype=dtype)``. In float32 torch's kernel; in bf16
    flax's own arithmetic: mean and mean square in f32, variance
    max(E[x²] - E[x]², 0), (x - mean) · (rsqrt(var + eps) · scale) + bias
    in f32, then one rounding to ``dtype``."""
    if dtype == torch.float32:
        return norm(x.to(dtype))
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    y = (xf - mean) * (torch.rsqrt(var + norm.eps) * norm.weight) + norm.bias
    return y.to(dtype)


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jax.nn.softmax`` in ``x``'s dtype. In bf16 its steps round as
    JAX's do: exp(x − max), its sum, the quotient (torch's fused bf16
    softmax rounds only once)."""
    if x.dtype != torch.bfloat16:
        return torch.softmax(x, dim=dim)
    e = torch.exp(x - torch.amax(x, dim=dim, keepdim=True))
    return e / torch.sum(e, dim=dim, keepdim=True)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU, ``jax.nn.gelu(approximate=False)``: 0.5·x·erfc(−x·√½).
    In bf16 as XLA evaluates it: √½ rounded to bf16, erfc taken in f32 and
    rounded, the product in bf16."""
    if x.dtype != torch.bfloat16:
        return F.gelu(x, approximate="none")
    return (0.5 * x) * torch.special.erfc(-x.float() * _SQRT_HALF_BF16).to(x.dtype)


def _sqrt_d(d: int, dtype: torch.dtype) -> float:
    """√d rounded to ``dtype`` (JAX's ``jnp.sqrt(jnp.asarray(d, dtype))``)."""
    return float(torch.tensor(float(d), dtype=dtype).sqrt())


def dropout(
    x: torch.Tensor,
    rate: float,
    deterministic: bool,
    generator,
    lane_axis: int = 0,
) -> torch.Tensor:
    """flax ``nn.Dropout``: ``where(uniform < 1 - rate, x / (1 - rate),
    0)``, one uniform per element from ``generator`` (a ``torch.Generator``
    or a rank's ``core.mesh.ShardedDraws``, whose lanes lie on
    ``lane_axis``); the identity when ``deterministic`` or ``rate == 0``
    (nothing is drawn then)."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    m = rand(x.shape, generator, x.device, axis=lane_axis) < keep
    return torch.where(m, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class PMGTEmbeddings(nn.Module):
    """Multimodal fusion + position/role embeddings.

    Per-modality linear projection to hidden size, softmax attention over
    modalities, plus absolute-position and role embeddings (role 0 = the
    target at position 0, role 1 = context). ``project`` applies the
    projections to whole feature tables, so callers can gather compact
    [N+2, H] rows and pass ``projected=True``.
    """

    def __init__(self, cfg: PMGTConfig):
        super().__init__()
        self.config = cfg
        self.dtype = compute_dtype(cfg)
        self.feat_linear = nn.ModuleList(
            nn.Linear(f, cfg.hidden_size) for f in cfg.feat_hidden_sizes
        )
        self.modality_attention = nn.Linear(
            cfg.hidden_size * cfg.num_feats, cfg.num_feats
        )
        self.position_embeddings = nn.Parameter(
            torch.zeros(cfg.max_position_embeddings, cfg.hidden_size)
        )
        self.role_embeddings = nn.Parameter(torch.zeros(2, cfg.hidden_size))
        self.norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def project(self, feat_tables) -> List[torch.Tensor]:
        """[N+2, F_m] tables (plain or int8) → [N+2, H] projected tables in
        the compute dtype; a row-sharded table's block → the projected
        block, sharded alike."""
        dt = self.dtype
        out = []
        for lin, t in zip(self.feat_linear, feat_tables):
            if isinstance(t, ShardedTable):
                out.append(t._replace(local=linear(lin, dense_table(t.local, dt), dt)))
            else:
                out.append(linear(lin, dense_table(t, dt), dt))
        return out

    def forward(
        self,
        feat_embeds: Sequence[torch.Tensor],
        deterministic: bool = True,
        projected: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        dt = self.dtype
        seq_len = feat_embeds[0].shape[1]
        if projected:
            proj = [x.to(dt) for x in feat_embeds]
        else:
            proj = [linear(lin, x, dt) for lin, x in zip(self.feat_linear, feat_embeds)]
        concat = torch.cat(proj, dim=-1)
        scores = softmax(linear(self.modality_attention, torch.tanh(concat), dt))
        stacked = torch.stack(proj, dim=2)  # [B, S, M, H]
        fused = torch.sum(scores[..., None] * stacked, dim=2)

        pos = self.position_embeddings[:seq_len].to(dt)
        role_ids = torch.ones(seq_len, dtype=torch.int64, device=pos.device)
        role_ids[0] = 0
        role = self.role_embeddings[role_ids].to(dt)
        embeds = layer_norm(self.norm, fused + pos[None] + role[None], dt)
        return dropout(
            embeds, self.config.hidden_dropout_prob, deterministic, generator
        )


def dual_attention_plain(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    ctx: torch.Tensor,
    additive_mask: Optional[torch.Tensor],
    beta: float,
    keep_masks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    keep: float = 1.0,
    scores2_bias: Optional[torch.Tensor] = None,
    head_mask: Optional[torch.Tensor] = None,
    return_probs: bool = False,
):
    """Plain batch-major dual attention (the JAX package's
    ``dual_attention_xla``), math in the inputs' dtype. Inputs [B, h, S,
    d], output (β·softmax(1 − cos(c, c) + I + M) + (1 − β)·softmax(qkᵀ/√d
    + bias + M))·v. ``keep_masks`` (m1, m2), bool [B, h, S, S], apply
    attention dropout as ``where(m, P / keep, 0)``; ``scores2_bias`` (the
    relative-position term, [B, h, S, S]) biases the qk distribution only;
    ``head_mask`` ([h] or broadcastable) scales both distributions after
    dropout. With ``return_probs`` the blended probs are returned too."""
    s, d = query.shape[-2], query.shape[-1]
    dtype = query.dtype
    ctx_norm = torch.linalg.norm(ctx, dim=-1, keepdim=True)  # [B,h,S,1]
    norm_outer = ctx_norm @ ctx_norm.transpose(-1, -2)
    cos = (ctx @ ctx.transpose(-1, -2)) / torch.clamp(norm_outer, min=1e-12)
    eye = torch.eye(s, dtype=dtype, device=query.device)
    scores1 = 1.0 - cos + eye
    if additive_mask is not None:
        scores1 = scores1 + additive_mask
    probs1 = softmax(scores1)

    scores2 = (query @ key.transpose(-1, -2)) / _sqrt_d(d, dtype)
    if scores2_bias is not None:
        scores2 = scores2 + scores2_bias
    if additive_mask is not None:
        scores2 = scores2 + additive_mask
    probs2 = softmax(scores2)
    if keep_masks is not None:
        zero = torch.zeros((), dtype=probs1.dtype, device=probs1.device)
        probs1 = torch.where(keep_masks[0], probs1 / keep, zero)
        probs2 = torch.where(keep_masks[1], probs2 / keep, zero)
    if head_mask is not None:
        hm = head_mask.to(dtype)
        if hm.ndim == 1:
            hm = hm[None, :, None, None]
        probs1 = probs1 * hm
        probs2 = probs2 * hm
    probs = beta * probs1 + (1.0 - beta) * probs2
    out = probs @ value
    return (out, probs) if return_probs else out


class PMGTSelfAttention(nn.Module):
    """Dual self-attention over the seq-major stream."""

    def __init__(self, cfg: PMGTConfig):
        super().__init__()
        self.config = cfg
        self.dtype = compute_dtype(cfg)
        if cfg.attention_impl not in ("xla", "pallas"):
            raise ValueError(f"unknown attention_impl {cfg.attention_impl!r}")
        if cfg.position_embedding_type not in ("absolute", *RELATIVE_POSITIONS):
            raise ValueError(
                f"unknown position_embedding_type {cfg.position_embedding_type!r}"
            )
        self.query = nn.Linear(cfg.hidden_size, cfg.all_head_size)
        self.key = nn.Linear(cfg.hidden_size, cfg.all_head_size)
        self.value = nn.Linear(cfg.hidden_size, cfg.all_head_size)
        self.ctx_attention = nn.Linear(cfg.hidden_size, cfg.all_head_size)
        if cfg.position_embedding_type in RELATIVE_POSITIONS:
            self.distance_embedding = nn.Parameter(
                torch.zeros(2 * cfg.max_position_embeddings - 1, cfg.head_dim)
            )

    def _relative_bias(self, query, key, s, b) -> torch.Tensor:
        """The relative-position term of the qk scores, [B, h, S, S],
        pre-divided by √d: rel[l, r] = q_l·E[l−r] (+ k_r·E[l−r] for
        ``relative_key_query``)."""
        cfg = self.config
        h, d = cfg.num_attention_heads, cfg.head_dim
        pos = torch.arange(s, device=query.device)
        distance = pos[:, None] - pos[None, :]
        rel = self.distance_embedding.to(self.dtype)[
            distance + cfg.max_position_embeddings - 1
        ]  # [S, S, d]
        rel_scores = torch.einsum("lbhd,lrd->bhlr", query.reshape(s, b, h, d), rel)
        if cfg.position_embedding_type == "relative_key_query":
            rel_scores = rel_scores + torch.einsum(
                "rbhd,lrd->bhlr", key.reshape(s, b, h, d), rel
            )
        return rel_scores / _sqrt_d(d, self.dtype)

    def forward(
        self,
        hidden_sm: torch.Tensor,  # [S, B, H]
        additive_bs: torch.Tensor,  # [B, S]
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
        head_mask: Optional[torch.Tensor] = None,
        output_attentions: bool = False,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(output [S, B, h·d], blended probs [B, h, S, S] with
        ``output_attentions``, else None)."""
        cfg = self.config
        dt = self.dtype
        s, b, _ = hidden_sm.shape
        h, d = cfg.num_attention_heads, cfg.head_dim
        flat = hidden_sm.reshape(s * b, hidden_sm.shape[-1])
        # [S*B, h*d] rows stay seq-major: the [S, B*h, d] view is free.
        query, key, value, ctx = (
            linear(lin, flat, dt)
            for lin in (self.query, self.key, self.value, self.ctx_attention)
        )
        rate = cfg.attention_probs_dropout_prob
        use_dropout = not deterministic and rate > 0.0
        keep = 1.0 - rate
        # One pair of [S, B*h, S] keep masks for either route, so both see
        # the same dropout pattern.
        m1 = m2 = None
        if use_dropout:
            m1, m2 = draw_keep_masks(s, b * h, keep, generator, group=h)
        bias = None
        if cfg.position_embedding_type in RELATIVE_POSITIONS:
            bias = self._relative_bias(query, key, s, b)
        if (cfg.attention_impl == "pallas" and bias is None and head_mask is None
                and not output_attentions):
            fold = lambda x: x.reshape(s, b * h, d)  # noqa: E731
            mask_nb = additive_bs[:, None, :].expand(b, h, s).reshape(b * h, s)
            out = dual_attention_sm(
                fold(query), fold(key), fold(value), fold(ctx), mask_nb,
                m1, m2, cfg.beta, keep, use_dropout,
            )
            return out.reshape(s, b, cfg.all_head_size), None
        to_bm = lambda x: x.reshape(s, b, h, -1).permute(1, 2, 0, 3)  # noqa: E731
        out = dual_attention_plain(
            to_bm(query), to_bm(key), to_bm(value), to_bm(ctx),
            additive_bs[:, None, None, :], beta=cfg.beta,
            keep_masks=(to_bm(m1), to_bm(m2)) if use_dropout else None,
            keep=keep, scores2_bias=bias, head_mask=head_mask,
            return_probs=output_attentions,
        )
        probs = None
        if output_attentions:
            out, probs = out
        # [B, h, S, d] -> [S, B, h*d]
        return out.permute(2, 0, 1, 3).reshape(s, b, cfg.all_head_size), probs


class PMGTLayer(nn.Module):
    """Dual attention + BERT-style FFN with post-LN residuals and
    exact-erf GELU, on flat [S*B, H] rows."""

    def __init__(self, cfg: PMGTConfig):
        super().__init__()
        self.config = cfg
        self.dtype = compute_dtype(cfg)
        self.self_attention = PMGTSelfAttention(cfg)
        self.attention_output = nn.Linear(cfg.all_head_size, cfg.hidden_size)
        self.attention_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.intermediate = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.output_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(
        self,
        hidden: torch.Tensor,  # [S, B, H]
        additive_bs: torch.Tensor,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
        head_mask: Optional[torch.Tensor] = None,
        output_attentions: bool = False,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        dt = self.dtype
        rate = self.config.hidden_dropout_prob
        attn, probs = self.self_attention(
            hidden, additive_bs, deterministic, generator, head_mask, output_attentions
        )
        s, b, _ = attn.shape
        attn = linear(self.attention_output, attn.reshape(s * b, attn.shape[-1]), dt)
        # seq-major rows: the lanes are axis 1 of [S, B, H]
        attn = dropout(attn.reshape(s, b, -1), rate, deterministic, generator, 1)
        hidden = layer_norm(
            self.attention_norm, attn.reshape(s * b, -1) + hidden.reshape(s * b, -1), dt
        )
        inter = gelu(linear(self.intermediate, hidden, dt))
        out = dropout(linear(self.output, inter, dt).reshape(s, b, -1), rate, deterministic,
                      generator, 1).reshape(s * b, -1)
        out = layer_norm(self.output_norm, out + hidden, dt)
        return out.reshape(s, b, -1), probs


def _checkpointed(layer: PMGTLayer, hidden, additive_bs, deterministic, generator, *rest):
    """``layer(hidden, ...)`` recomputed in the backward. The first pass
    draws from ``generator`` itself; the recompute from a fresh generator
    set to the state the layer entered with, so it replays the same
    dropout draws."""
    entry = generator.get_state() if generator is not None else None
    first = [True]

    def run(h):
        gen = generator
        if not first[0] and generator is not None:
            if isinstance(generator, ShardedDraws):
                gen = generator.restored(entry)
            else:
                gen = torch.Generator(device=generator.device)
                gen.set_state(entry)
        first[0] = False
        return layer(h, additive_bs, deterministic, gen, *rest)

    return checkpoint(run, hidden, use_reentrant=False, preserve_rng_state=False)


class PMGTModel(nn.Module):
    """PMGT encoder trunk: embeddings + ``num_hidden_layers`` layers."""

    def __init__(self, cfg: PMGTConfig):
        super().__init__()
        self.config = cfg
        self.dtype = compute_dtype(cfg)
        self.embeddings = PMGTEmbeddings(cfg)
        self.layers = nn.ModuleList(
            PMGTLayer(cfg) for _ in range(cfg.num_hidden_layers)
        )

    def project_tables(self, feat_tables) -> List[torch.Tensor]:
        return self.embeddings.project(feat_tables)

    def forward(
        self,
        feat_embeds: Sequence[torch.Tensor],
        attention_mask: Optional[torch.Tensor] = None,
        deterministic: bool = True,
        projected: bool = False,
        head_mask: Optional[torch.Tensor] = None,
        output_hidden_states: bool = False,
        output_attentions: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        """Returns the last hidden state [B, S, H] in the compute dtype.
        With ``output_hidden_states`` / ``output_attentions`` it returns
        ``(last_hidden_state, aux)``: ``aux["hidden_states"]`` holds the
        embeddings' output and every layer's [B, S, H];
        ``aux["attentions"]`` every layer's blended probs [B, h, S, S].
        ``head_mask`` is [num_layers, h] or [h] (every layer).
        ``deterministic=False`` (dropout) needs ``generator``."""
        if not deterministic and generator is None:
            raise ValueError("deterministic=False needs a torch.Generator")
        b, s = feat_embeds[0].shape[:2]
        if attention_mask is None:
            attention_mask = torch.ones(
                (b, s), dtype=torch.float32, device=feat_embeds[0].device
            )
        additive_bs = _additive_mask(attention_mask, self.dtype)  # [B, S]
        hidden = self.embeddings(feat_embeds, deterministic, projected, generator)
        all_hidden = [hidden] if output_hidden_states else None
        all_attn = [] if output_attentions else None
        hidden = hidden.transpose(0, 1)  # seq-major [S, B, H]
        remat = self.config.gradient_checkpointing and torch.is_grad_enabled()
        if head_mask is not None:
            head_mask = torch.as_tensor(head_mask, device=hidden.device)
        for i, layer in enumerate(self.layers):
            layer_hm = None
            if head_mask is not None:
                layer_hm = head_mask[i] if head_mask.ndim > 1 else head_mask
            args = (additive_bs, deterministic, generator, layer_hm, output_attentions)
            if remat:
                hidden, probs = _checkpointed(layer, hidden, *args)
            else:
                hidden, probs = layer(hidden, *args)
            if output_hidden_states:
                all_hidden.append(hidden.transpose(0, 1))
            if output_attentions:
                all_attn.append(probs)
        hidden = hidden.transpose(0, 1)
        if not (output_hidden_states or output_attentions):
            return hidden
        aux = {}
        if output_hidden_states:
            aux["hidden_states"] = tuple(all_hidden)
        if output_attentions:
            aux["attentions"] = tuple(all_attn)
        return hidden, aux


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy with logits, no reduction:
    max(x, 0) - x·y + log1p(exp(-|x|)). max(x, 0) is written (x + |x|) / 2
    (the same value in floating point) so that its gradient at x = 0 is
    1/2, as ``jnp.maximum``'s is: the loss's gradient there is then the
    true sigmoid(0) - y (``torch.clamp``'s 1 gave 1 - y, at every logit of
    exactly 0, e.g. behind a dead ReLU tower)."""
    return (
        0.5 * (logits + torch.abs(logits))
        - logits * labels
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )


def gsr_loss_fn(
    target_cls: torch.Tensor,  # [B, H]
    pair_cls: torch.Tensor,  # [B, P, H]
    labels: torch.Tensor,  # [B, P]
    pair_valid: torch.Tensor,  # [B, P]
    valid_samples: Optional[torch.Tensor] = None,
):
    """Graph Structure Reconstruction loss: L2-normalised CLS dot-product
    logits, BCE-with-logits, mean over each sample's valid pairs, then
    mean over samples. ``valid_samples`` replaces the count of samples
    with a valid pair (a data-parallel rank passes the global count).
    Returns (loss, logits [B, P])."""
    t = target_cls / torch.clamp(
        torch.linalg.norm(target_cls, dim=-1, keepdim=True), min=1e-12
    )
    p = pair_cls / torch.clamp(
        torch.linalg.norm(pair_cls, dim=-1, keepdim=True), min=1e-12
    )
    logits = torch.einsum("bh,bph->bp", t, p)
    per_pair = bce_with_logits(logits, labels) * pair_valid
    counts = torch.sum(pair_valid, dim=1)
    per_sample = torch.sum(per_pair, dim=1) / torch.clamp(counts, min=1.0)
    sample_valid = (counts > 0).to(per_sample.dtype)
    if valid_samples is None:
        valid_samples = torch.sum(sample_valid)
    loss = torch.sum(per_sample * sample_valid) / torch.clamp(valid_samples, min=1.0)
    return loss, logits


class PretrainOutput(NamedTuple):
    loss: torch.Tensor
    gsr_loss: torch.Tensor
    nfr_loss: torch.Tensor
    logits: torch.Tensor  # [B, P] pair logits
    target_cls: torch.Tensor  # [B, H]


class PMGTForPreTraining(nn.Module):
    """PMGT with the GSR and NFR pre-training heads. The frozen feature
    tables are inputs, not parameters: pass ``feat_tables`` (list of
    [N+2, F_m] tensors or ``QuantizedTable``s) to every call."""

    def __init__(
        self,
        config: PMGTConfig,
        node_size: int,
        random_node_ratio: float = 0.2 * 0.1,
        mask_node_ratio: float = 0.2 * 0.8,
    ):
        super().__init__()
        self.config = config
        self.node_size = node_size
        self.random_node_ratio = random_node_ratio
        self.mask_node_ratio = mask_node_ratio
        self.bert = PMGTModel(config)
        self.nfr_projections = nn.ModuleList(
            nn.Linear(config.hidden_size, f) for f in config.feat_hidden_sizes
        )

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Flax-style init: every Dense kernel and embedding table from
        normal(0, initializer_range), zero biases, unit LayerNorm scales.
        ``generator`` lives on the CPU; values are copied to the model's
        device."""
        std = self.config.initializer_range

        def normal_(p):
            p.copy_(torch.randn(p.shape, generator=generator) * std)

        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                normal_(mod.weight)
                mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        normal_(self.bert.embeddings.position_embeddings)
        normal_(self.bert.embeddings.role_embeddings)
        for layer in self.bert.layers:
            if hasattr(layer.self_attention, "distance_embedding"):
                normal_(layer.self_attention.distance_embedding)

    def project_tables(
        self, feat_tables: Sequence[torch.Tensor]
    ) -> List[torch.Tensor]:
        """Whole-table projections for the project_tables dataflow; pass
        them to ``encode``/``forward`` as ``proj_tables`` to reuse one
        projection across many batches."""
        return self.bert.project_tables(feat_tables)

    def encode(
        self,
        feat_tables: Sequence[torch.Tensor],
        node_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        deterministic: bool = True,
        proj_tables: Optional[Sequence[torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Encoder pass over [B, S] node-id sequences → [B, S, H]."""
        if self.config.fusion_strategy == "gather_rows":
            feat_embeds = tables_rows(feat_tables, node_ids, self.bert.dtype)
            projected = False
        else:
            if proj_tables is None:
                proj_tables = self.project_tables(feat_tables)
            feat_embeds = tables_rows(proj_tables, node_ids)
            projected = True
        return self.bert(
            feat_embeds, attention_mask, deterministic, projected,
            generator=generator,
        )

    def forward(
        self,
        feat_tables: Sequence[torch.Tensor],
        batch: PretrainBatch,
        deterministic: bool = True,
        compute_nfr: bool = False,
        proj_tables: Optional[Sequence[torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None,
        corruption: Optional[Tuple[torch.Tensor, ...]] = None,
        mesh: Optional[Mesh] = None,
    ) -> PretrainOutput:
        """One encoder pass over the lanes ``[targets | pairs | masked]``
        (the masked lane only with ``compute_nfr``) → GSR loss, NFR loss,
        ``loss = gsr + nfr`` and the pair logits. ``generator`` feeds the
        corruption draws (or pass them as ``corruption``, see ``_corrupt``)
        and then the dropout masks. With ``mesh`` the batch is this rank's
        share of the global micro-batch (see the module docstring): the
        losses are its parts of the global losses."""
        b, p, s = batch.pair_ids.shape
        w = mesh.size if mesh is not None else 1
        lanes = [batch.target_ids, batch.pair_ids.reshape(b * p, s)]
        mask_lanes = [batch.target_mask, batch.pair_mask.reshape(b * p, s)]
        segments = [(w * b, b), (w * b * p, b * p)]
        if compute_nfr:
            masked_ids, nfr_pos_mask, nfr_target_ids = self._corrupt(
                batch.target_ids, lane_draws(mesh, generator, segments[:1]), corruption
            )
            lanes.append(masked_ids)
            mask_lanes.append(batch.target_mask)
            segments.append((w * b, b))
        valid_samples = count = None
        if mesh is not None and mesh.distributed:
            valid_samples, count = all_reduce(mesh, torch.stack([
                torch.sum((torch.sum(batch.pair_valid, dim=1) > 0).to(torch.float32)),
                torch.sum(nfr_pos_mask) if compute_nfr else batch.pair_valid.new_zeros(()),
            ]))
        hidden = self.encode(
            feat_tables, torch.cat(lanes), torch.cat(mask_lanes),
            deterministic, proj_tables, lane_draws(mesh, generator, segments),
        )
        target_cls = hidden[:b, 0]
        pair_cls = hidden[b : b + b * p, 0].reshape(b, p, -1)
        gsr, logits = gsr_loss_fn(
            target_cls, pair_cls, batch.labels, batch.pair_valid, valid_samples
        )
        if compute_nfr:
            nfr = self._nfr_loss(
                feat_tables, hidden[b + b * p :], nfr_pos_mask, nfr_target_ids, count
            )
        else:
            nfr = torch.zeros((), dtype=gsr.dtype, device=gsr.device)
        return PretrainOutput(
            loss=gsr + nfr,
            gsr_loss=gsr,
            nfr_loss=nfr,
            logits=logits,
            target_cls=target_cls,
        )

    def _corrupt(
        self,
        target_ids: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        draws: Optional[Tuple[torch.Tensor, ...]] = None,
    ):
        """Random node replacement + masking for NFR. Never touches
        position 0 (the target) or padding; the NFR targets are the ids
        AFTER replacement. The replace and mask draws are independent, so
        a slot can be replaced and then masked (as in the reference).

        ``draws`` = (rand1, random_ids, rand2), each [B, S-1]: the replace
        uniforms, the random ids in [2, N+2) and the mask uniforms; without
        them the three are drawn from ``generator`` in that order.
        Returns (masked_ids [B, S], pos_mask [B, S-1] f32, targets
        [B, S-1])."""
        ctx = target_ids[:, 1:]
        dev = target_ids.device
        if draws is None:
            if generator is None:
                raise ValueError("NFR corruption needs a torch.Generator or draws")
            rand1 = rand(ctx.shape, generator, dev)
            random_ids = randint(
                NUM_SPECIAL_NODES, self.node_size + NUM_SPECIAL_NODES, ctx.shape, generator, dev
            )
            rand2 = rand(ctx.shape, generator, dev)
        else:
            rand1, random_ids, rand2 = (torch.as_tensor(x, device=dev) for x in draws)
        replace = (rand1 < self.random_node_ratio) & (ctx != 0)
        ctx_replaced = torch.where(replace, random_ids.to(ctx.dtype), ctx)
        masked = (rand2 < self.mask_node_ratio) & (ctx_replaced != 0)
        ctx_masked = torch.where(masked, torch.ones_like(ctx_replaced), ctx_replaced)
        masked_ids = torch.cat([target_ids[:, :1], ctx_masked], dim=1)
        return masked_ids, masked.to(torch.float32), ctx_replaced

    def _nfr_loss(
        self,
        feat_tables: Sequence[torch.Tensor],
        masked_hidden: torch.Tensor,  # [B, S, H]
        pos_mask: torch.Tensor,  # [B, S-1], 1 where a context slot was masked
        target_ids: torch.Tensor,  # [B, S-1] post-replacement ids
        count: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Node Feature Reconstruction: per modality, project the masked
        positions' hidden states, squared error against the original
        feature rows summed over F in f32, masked mean with denominator
        ``max(count * F, 1)`` (``count``: the masked slots, or the global
        count a data-parallel rank passes); then the mean over
        modalities."""
        ctx_hidden = masked_hidden[:, 1:]
        if count is None:
            count = torch.sum(pos_mask)
        dt = self.bert.dtype
        targets = tables_rows(feat_tables, target_ids, dt)
        losses = []
        for proj, target in zip(self.nfr_projections, targets):
            pred = linear(proj, ctx_hidden, dt)  # [B, S-1, F]
            sq = torch.sum((pred - target) ** 2, dim=-1, dtype=torch.float32)
            denom = torch.clamp(count * pred.shape[-1], min=1.0)
            losses.append(torch.sum(sq * pos_mask) / denom)
        return torch.mean(torch.stack(losses))
