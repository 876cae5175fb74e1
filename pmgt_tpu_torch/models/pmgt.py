"""PMGT encoder and pretraining model (counterpart of
``pmgt_tpu/models/pmgt.py``).

The residual stream runs seq-major [S, B, H] through the layers, as in the
JAX package, so the dual-attention kernel reads position slices of the
flat [S*B, H] projection outputs without a relayout. Public inputs and
outputs stay batch-major [B, S, H].

``config.attention_impl`` picks the attention route: ``"pallas"`` goes
through ``ops.dual_attention.dual_attention_sm`` (the hand-written CUDA
kernel on a GPU, its plain version on the CPU); ``"xla"`` runs the plain
batch-major formulation ``dual_attention_plain``.

Training (``deterministic=False``) needs a ``torch.Generator`` on the
model's device; there is no global RNG and no ``nn.Dropout``. One forward
draws, in this order: the NFR corruption (``_corrupt``: replace uniforms,
random ids, mask uniforms), then the embeddings' dropout mask, then per
layer the attention keep masks m1 and m2 (``draw_keep_masks``, one pair
for both attention routes), the ``attention_output`` dropout mask and the
``output`` dropout mask. Dropout is flax's: ``where(u < keep, x / keep,
0)``. Gradient checkpointing, the bf16 compute policy, relative-position
attention, ``head_mask`` and ``output_attentions`` raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pmgt_tpu_torch.core.config import PMGTConfig
from pmgt_tpu_torch.core.quant import dense_table, table_rows
from pmgt_tpu_torch.graph.container import NUM_SPECIAL_NODES
from pmgt_tpu_torch.ops.dual_attention import draw_keep_masks, dual_attention_sm
from pmgt_tpu_torch.sampling.pairs import PretrainBatch


def _additive_mask(attention_mask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(1 - mask) * finfo(dtype).min — HF's extended attention mask."""
    big_neg = torch.finfo(dtype).min
    return ((1.0 - attention_mask) * big_neg).to(dtype)


def dropout(
    x: torch.Tensor,
    rate: float,
    deterministic: bool,
    generator: Optional[torch.Generator],
) -> torch.Tensor:
    """flax ``nn.Dropout``: ``where(uniform < 1 - rate, x / (1 - rate),
    0)``, one uniform per element from ``generator``; the identity when
    ``deterministic`` or ``rate == 0`` (nothing is drawn then)."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    m = torch.rand(x.shape, generator=generator, device=x.device) < keep
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

    def project(self, feat_tables: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """[N+2, F_m] tables → [N+2, H] projected tables."""
        return [
            lin(dense_table(t, torch.float32))
            for lin, t in zip(self.feat_linear, feat_tables)
        ]

    def forward(
        self,
        feat_embeds: Sequence[torch.Tensor],
        deterministic: bool = True,
        projected: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        seq_len = feat_embeds[0].shape[1]
        if projected:
            proj = [x.to(torch.float32) for x in feat_embeds]
        else:
            proj = [
                lin(x.to(torch.float32))
                for lin, x in zip(self.feat_linear, feat_embeds)
            ]
        concat = torch.cat(proj, dim=-1)
        scores = torch.softmax(
            self.modality_attention(torch.tanh(concat)), dim=-1
        )
        stacked = torch.stack(proj, dim=2)  # [B, S, M, H]
        fused = torch.sum(scores[..., None] * stacked, dim=2)

        pos = self.position_embeddings[:seq_len]
        role_ids = torch.ones(seq_len, dtype=torch.int64, device=pos.device)
        role_ids[0] = 0
        role = self.role_embeddings[role_ids]
        embeds = self.norm(fused + pos[None] + role[None])
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
) -> torch.Tensor:
    """Plain batch-major dual attention (the math of the JAX package's
    ``dual_attention_xla``). Inputs [B, h, S, d], output
    (β·softmax(1 − cos(c, c) + I + M) + (1 − β)·softmax(qkᵀ/√d + M))·v.
    ``keep_masks`` (m1, m2), bool [B, h, S, S], apply attention dropout as
    ``where(m, P / keep, 0)``."""
    s, d = query.shape[-2], query.shape[-1]
    ctx_norm = torch.linalg.norm(ctx, dim=-1, keepdim=True)  # [B,h,S,1]
    norm_outer = ctx_norm @ ctx_norm.transpose(-1, -2)
    cos = (ctx @ ctx.transpose(-1, -2)) / torch.clamp(norm_outer, min=1e-12)
    eye = torch.eye(s, dtype=query.dtype, device=query.device)
    scores1 = 1.0 - cos + eye
    if additive_mask is not None:
        scores1 = scores1 + additive_mask
    probs1 = torch.softmax(scores1, dim=-1)

    scores2 = (query @ key.transpose(-1, -2)) / (float(d) ** 0.5)
    if additive_mask is not None:
        scores2 = scores2 + additive_mask
    probs2 = torch.softmax(scores2, dim=-1)
    if keep_masks is not None:
        zero = torch.zeros((), dtype=probs1.dtype, device=probs1.device)
        probs1 = torch.where(keep_masks[0], probs1 / keep, zero)
        probs2 = torch.where(keep_masks[1], probs2 / keep, zero)
    probs = beta * probs1 + (1.0 - beta) * probs2
    return probs @ value


class PMGTSelfAttention(nn.Module):
    """Dual self-attention over the seq-major stream."""

    def __init__(self, cfg: PMGTConfig):
        super().__init__()
        self.config = cfg
        if cfg.attention_impl not in ("xla", "pallas"):
            raise ValueError(f"unknown attention_impl {cfg.attention_impl!r}")
        self.query = nn.Linear(cfg.hidden_size, cfg.all_head_size)
        self.key = nn.Linear(cfg.hidden_size, cfg.all_head_size)
        self.value = nn.Linear(cfg.hidden_size, cfg.all_head_size)
        self.ctx_attention = nn.Linear(cfg.hidden_size, cfg.all_head_size)

    def forward(
        self,
        hidden_sm: torch.Tensor,  # [S, B, H]
        additive_bs: torch.Tensor,  # [B, S]
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        cfg = self.config
        s, b, _ = hidden_sm.shape
        h, d = cfg.num_attention_heads, cfg.head_dim
        flat = hidden_sm.reshape(s * b, hidden_sm.shape[-1])
        # [S*B, h*d] rows stay seq-major: the [S, B*h, d] view is free.
        query, key, value, ctx = (
            lin(flat)
            for lin in (self.query, self.key, self.value, self.ctx_attention)
        )
        rate = cfg.attention_probs_dropout_prob
        use_dropout = not deterministic and rate > 0.0
        keep = 1.0 - rate
        # One pair of [S, B*h, S] keep masks for either route, so both see
        # the same dropout pattern.
        m1 = m2 = None
        if use_dropout:
            m1, m2 = draw_keep_masks(s, b * h, keep, generator)
        if cfg.attention_impl == "pallas":
            fold = lambda x: x.reshape(s, b * h, d)  # noqa: E731
            mask_nb = additive_bs[:, None, :].expand(b, h, s).reshape(b * h, s)
            out = dual_attention_sm(
                fold(query), fold(key), fold(value), fold(ctx), mask_nb,
                m1, m2, cfg.beta, keep, use_dropout,
            )
            return out.reshape(s, b, cfg.all_head_size)
        to_bm = lambda x: x.reshape(s, b, h, -1).permute(1, 2, 0, 3)  # noqa: E731
        out = dual_attention_plain(
            to_bm(query), to_bm(key), to_bm(value), to_bm(ctx),
            additive_bs[:, None, None, :], beta=cfg.beta,
            keep_masks=(to_bm(m1), to_bm(m2)) if use_dropout else None,
            keep=keep,
        )
        # [B, h, S, d] -> [S, B, h*d]
        return out.permute(2, 0, 1, 3).reshape(s, b, cfg.all_head_size)


class PMGTLayer(nn.Module):
    """Dual attention + BERT-style FFN with post-LN residuals and
    exact-erf GELU, on flat [S*B, H] rows."""

    def __init__(self, cfg: PMGTConfig):
        super().__init__()
        self.config = cfg
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
    ) -> torch.Tensor:
        rate = self.config.hidden_dropout_prob
        attn = self.self_attention(hidden, additive_bs, deterministic, generator)
        s, b, _ = attn.shape
        attn = self.attention_output(attn.reshape(s * b, attn.shape[-1]))
        attn = dropout(attn, rate, deterministic, generator)
        hidden = self.attention_norm(
            attn + hidden.reshape(s * b, hidden.shape[-1])
        )
        inter = F.gelu(self.intermediate(hidden), approximate="none")
        out = dropout(self.output(inter), rate, deterministic, generator)
        out = self.output_norm(out + hidden)
        return out.reshape(s, b, -1)


class PMGTModel(nn.Module):
    """PMGT encoder trunk: embeddings + ``num_hidden_layers`` layers."""

    def __init__(self, cfg: PMGTConfig):
        super().__init__()
        if cfg.dtype != "float32":
            raise NotImplementedError(
                f"compute dtype {cfg.dtype!r}: only float32 is ported yet"
            )
        if cfg.position_embedding_type != "absolute":
            raise NotImplementedError(
                f"position_embedding_type {cfg.position_embedding_type!r}: "
                "only 'absolute' is ported yet"
            )
        if cfg.gradient_checkpointing:
            raise NotImplementedError("gradient checkpointing is not ported yet")
        self.config = cfg
        self.embeddings = PMGTEmbeddings(cfg)
        self.layers = nn.ModuleList(
            PMGTLayer(cfg) for _ in range(cfg.num_hidden_layers)
        )

    def project_tables(
        self, feat_tables: Sequence[torch.Tensor]
    ) -> List[torch.Tensor]:
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
    ) -> torch.Tensor:
        """Returns the last hidden state [B, S, H]. ``deterministic=False``
        (dropout) needs ``generator``."""
        if head_mask is not None or output_hidden_states or output_attentions:
            raise NotImplementedError(
                "head_mask / output_hidden_states / output_attentions are "
                "not ported yet"
            )
        if not deterministic and generator is None:
            raise ValueError("deterministic=False needs a torch.Generator")
        b, s = feat_embeds[0].shape[:2]
        if attention_mask is None:
            attention_mask = torch.ones(
                (b, s), dtype=torch.float32, device=feat_embeds[0].device
            )
        additive_bs = _additive_mask(attention_mask, torch.float32)  # [B, S]
        hidden = self.embeddings(feat_embeds, deterministic, projected, generator)
        hidden = hidden.transpose(0, 1)  # seq-major [S, B, H]
        for layer in self.layers:
            hidden = layer(hidden, additive_bs, deterministic, generator)
        return hidden.transpose(0, 1)


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
):
    """Graph Structure Reconstruction loss: L2-normalised CLS dot-product
    logits, BCE-with-logits, mean over each sample's valid pairs, then
    mean over samples. Returns (loss, logits [B, P])."""
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
    loss = torch.sum(per_sample * sample_valid) / torch.clamp(
        torch.sum(sample_valid), min=1.0
    )
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
    [N+2, F_m] tensors) to every call."""

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
            feat_embeds = [
                table_rows(t, node_ids, torch.float32) for t in feat_tables
            ]
            projected = False
        else:
            if proj_tables is None:
                proj_tables = self.project_tables(feat_tables)
            feat_embeds = [t[node_ids] for t in proj_tables]
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
    ) -> PretrainOutput:
        """One encoder pass over the lanes ``[targets | pairs | masked]``
        (the masked lane only with ``compute_nfr``) → GSR loss, NFR loss,
        ``loss = gsr + nfr`` and the pair logits. ``generator`` feeds the
        corruption draws (or pass them as ``corruption``, see ``_corrupt``)
        and then the dropout masks."""
        b, p, s = batch.pair_ids.shape
        lanes = [batch.target_ids, batch.pair_ids.reshape(b * p, s)]
        mask_lanes = [batch.target_mask, batch.pair_mask.reshape(b * p, s)]
        if compute_nfr:
            masked_ids, nfr_pos_mask, nfr_target_ids = self._corrupt(
                batch.target_ids, generator, corruption
            )
            lanes.append(masked_ids)
            mask_lanes.append(batch.target_mask)
        hidden = self.encode(
            feat_tables, torch.cat(lanes), torch.cat(mask_lanes),
            deterministic, proj_tables, generator,
        )
        target_cls = hidden[:b, 0]
        pair_cls = hidden[b : b + b * p, 0].reshape(b, p, -1)
        gsr, logits = gsr_loss_fn(
            target_cls, pair_cls, batch.labels, batch.pair_valid
        )
        if compute_nfr:
            nfr = self._nfr_loss(
                feat_tables, hidden[b + b * p :], nfr_pos_mask, nfr_target_ids
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
            rand1 = torch.rand(ctx.shape, generator=generator, device=dev)
            random_ids = torch.randint(
                NUM_SPECIAL_NODES, self.node_size + NUM_SPECIAL_NODES,
                ctx.shape, generator=generator, device=dev,
            )
            rand2 = torch.rand(ctx.shape, generator=generator, device=dev)
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
    ) -> torch.Tensor:
        """Node Feature Reconstruction: per modality, project the masked
        positions' hidden states, squared error against the original
        feature rows summed over F in f32, masked mean with denominator
        ``max(count * F, 1)``; then the mean over modalities."""
        ctx_hidden = masked_hidden[:, 1:]
        count = torch.sum(pos_mask)
        losses = []
        for proj, table in zip(self.nfr_projections, feat_tables):
            pred = proj(ctx_hidden)  # [B, S-1, F]
            target = table_rows(table, target_ids, pred.dtype)
            sq = torch.sum((pred - target) ** 2, dim=-1, dtype=torch.float32)
            denom = torch.clamp(count * pred.shape[-1], min=1.0)
            losses.append(torch.sum(sq * pos_mask) / denom)
        return torch.mean(torch.stack(losses))
