"""PMGT_NCF: an NCF whose item tower is a full PMGT encoder over the item's
sampled neighbourhood (counterpart of ``pmgt_tpu/models/pmgt_ncf.py``;
reference pmgt/pmgt_ncf/models.py:15-105).

The frozen multimodal tables are inputs, as in ``PMGTForPreTraining``.
The CLS state of the encoded neighbourhood is the MLP tower's item
embedding; ``NeuMF-end`` adds a GMF branch indexed by the raw item id,
clipped to the table (never node id - 2, which would send a graph-absent
item, node 0, to another item's row). The encoder is the port's
``PMGTModel``, so on the card its attention runs K1 forward and K2
backward (``attention_impl="pallas"``). It runs in the config's compute
dtype; under bf16 its CLS row meets the f32 user embedding in a
concatenation that promotes to f32, as JAX's does, so the towers and the
logits stay f32.

``forward`` is ``towers`` over ``encode_items``: the item stage (the
encoder; deterministic, its CLS state is a function of the item alone)
and the pair stage (the NeuMF towers). Serving runs the item stage once
per catalogue item and the pair stage per (user, item) pair.

``init_weights``: the encoder as ``PMGTForPreTraining.init_weights`` (flax
normal(initializer_range) kernels and embeddings, zero biases, unit
LayerNorm scales), embeddings N(0, 0.01), tower kernels xavier-uniform,
the predict kernel flax's lecun-normal. One generator draws, in order, the
encoder's dropout (``models/pmgt.py``), the embedding dropout of the MLP
input, each tower layer's, then the GMF product's.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from pmgt_tpu_torch.core.config import PMGTConfig
from pmgt_tpu_torch.core.quant import tables_rows
from pmgt_tpu_torch.models.initializers import lecun_normal_, normal_, xavier_uniform_
from pmgt_tpu_torch.models.pmgt import PMGTModel, dropout


class PMGT_NCF(nn.Module):
    def __init__(
        self,
        user_num: int,
        item_num: int,
        config: PMGTConfig,
        factor_num: int = 32,
        num_layers: int = 3,
        emb_dropout: float = 0.0,
        dropout: float = 0.0,
        model: str = "MLP",
    ):
        super().__init__()
        if model not in ("MLP", "NeuMF-end"):
            raise ValueError(f"model must be MLP or NeuMF-end, got {model!r}")
        self.config = config
        self.item_num = item_num
        self.model = model
        self.emb_dropout = emb_dropout
        self.dropout = dropout
        fn, nl = factor_num, num_layers
        self.bert = PMGTModel(config)
        self.mlp_user_embeddings = nn.Embedding(user_num, fn * 2 ** (nl - 1))
        # Tower fn * 2^(nl - i) -> half; its input is [user fn*2^(nl-1) ;
        # item hidden_size] (reference pmgt_ncf/models.py:55-76).
        outs = [fn * 2 ** (nl - i) // 2 for i in range(nl)]
        ins = [fn * 2 ** (nl - 1) + config.hidden_size, *outs[:-1]]
        self.mlp_layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(ins, outs))
        if model == "NeuMF-end":
            self.gmf_user_embeddings = nn.Embedding(user_num, fn)
            self.gmf_item_embeddings = nn.Embedding(item_num, fn)
        self.predict_layer = nn.Linear(outs[-1] + (fn if model == "NeuMF-end" else 0), 1)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        std = self.config.initializer_range
        for mod in self.bert.modules():
            if isinstance(mod, nn.Linear):
                normal_(mod.weight, std, generator)
                mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        normal_(self.bert.embeddings.position_embeddings, std, generator)
        normal_(self.bert.embeddings.role_embeddings, std, generator)
        normal_(self.mlp_user_embeddings.weight, 0.01, generator)
        for layer in self.mlp_layers:
            xavier_uniform_(layer.weight, generator)
            layer.bias.zero_()
        if self.model == "NeuMF-end":
            normal_(self.gmf_user_embeddings.weight, 0.01, generator)
            normal_(self.gmf_item_embeddings.weight, 0.01, generator)
        lecun_normal_(self.predict_layer.weight, generator)
        self.predict_layer.bias.zero_()

    def project_tables(self, feat_tables: Sequence[torch.Tensor]):
        """Whole-table projections for the project_tables dataflow; pass
        them as ``proj_tables`` to reuse one projection across calls."""
        return self.bert.project_tables(feat_tables)

    def encode_items(
        self,
        feat_tables: Sequence[torch.Tensor],
        item_node_ids: torch.Tensor,  # [B, S] neighbourhood sequences
        item_attention_mask: torch.Tensor,  # [B, S]
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
        proj_tables: Optional[Sequence[torch.Tensor]] = None,
    ) -> torch.Tensor:
        """The item stage: the CLS states [B, H] of the items' encoded
        neighbourhoods, in the encoder's compute dtype. It draws the
        encoder's dropout."""
        if self.config.fusion_strategy == "gather_rows":
            feats = tables_rows(feat_tables, item_node_ids, self.bert.dtype)
            projected = False
        else:
            if proj_tables is None:
                proj_tables = self.project_tables(feat_tables)
            feats = tables_rows(proj_tables, item_node_ids)
            projected = True
        hidden = self.bert(feats, item_attention_mask, deterministic, projected,
                           generator=generator)
        return hidden[:, 0]

    def towers(
        self,
        user: torch.Tensor,  # [B]
        item_cls: torch.Tensor,  # [B, H] rows of ``encode_items``
        item: Optional[torch.Tensor],  # [B] raw item ids (GMF; read by NeuMF-end only)
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """The pair stage: logits [B] of (user, item) pairs from the items'
        CLS states. It draws the embedding dropout, each tower layer's,
        then the GMF product's."""
        x = torch.cat([self.mlp_user_embeddings(user), item_cls], dim=-1)
        x = dropout(x, self.emb_dropout, deterministic, generator)
        for layer in self.mlp_layers:
            x = torch.relu(dropout(layer(x), self.dropout, deterministic, generator))
        if self.model == "NeuMF-end":
            item_idx = torch.clamp(item, 0, self.item_num - 1)
            gmf = self.gmf_user_embeddings(user) * self.gmf_item_embeddings(item_idx)
            gmf = dropout(gmf, self.emb_dropout, deterministic, generator)
            x = torch.cat([gmf, x], dim=-1)
        return self.predict_layer(x)[..., 0]

    def forward(
        self,
        feat_tables: Sequence[torch.Tensor],
        user: torch.Tensor,  # [B]
        item_node_ids: torch.Tensor,  # [B, S] neighbourhood sequences
        item_attention_mask: torch.Tensor,  # [B, S]
        item: Optional[torch.Tensor] = None,  # [B] raw item ids (GMF)
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
        proj_tables: Optional[Sequence[torch.Tensor]] = None,
    ) -> torch.Tensor:
        """Logits [B]: ``towers`` over ``encode_items``. Without ``item``,
        GMF takes node id - 2."""
        item_cls = self.encode_items(feat_tables, item_node_ids, item_attention_mask,
                                     deterministic, generator, proj_tables)
        if item is None and self.model == "NeuMF-end":
            item = item_node_ids[:, 0] - 2
        return self.towers(user, item_cls, item, deterministic, generator)
