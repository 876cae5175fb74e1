"""Neural Collaborative Filtering: GMF / MLP / NeuMF-end / NeuMF-pre
(counterpart of ``pmgt_tpu/models/ncf.py``; reference pmgt/ncf/models.py).

One module for the four variants; ``model`` picks the towers. NeuMF-pre
is NeuMF's architecture with parameters fused from a trained GMF and a
trained MLP (``fuse_neumf_params``); PMGT item embeddings enter the MLP
item table through ``inject_item_embeddings``. Both work on ``state_dict``s.

``init_weights`` follows the JAX package's initialisers: embeddings
N(0, 0.01), tower kernels xavier-uniform, the predict kernel
U(±sqrt(3 / fan_in)) (torch's kaiming_uniform(a=1) of the reference),
zero biases, unit LayerNorm scales. Dropout is flax's, drawn from an
explicit ``torch.Generator`` (``models.pmgt.dropout``): the embedding
dropout of the GMF product, then of the MLP input, then each tower
layer's.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from pmgt_tpu_torch.models.initializers import normal_, uniform_, xavier_uniform_
from pmgt_tpu_torch.models.pmgt import dropout

VARIANTS = ("MLP", "GMF", "NeuMF-end", "NeuMF-pre")


class NCF(nn.Module):
    def __init__(
        self,
        user_num: int,
        item_num: int,
        factor_num: int = 32,
        num_layers: int = 3,
        emb_dropout: float = 0.0,
        dropout: float = 0.0,
        use_layer_norm: bool = False,
        layer_norm_eps: float = 1e-12,
        model: str = "NeuMF-end",
    ):
        super().__init__()
        if model not in VARIANTS:
            raise ValueError(f"model must be one of {VARIANTS}, got {model!r}")
        self.model = model
        self.emb_dropout = emb_dropout
        self.dropout = dropout
        fn, nl = factor_num, num_layers
        mlp_dim = fn * 2 ** (nl - 1)
        if model != "MLP":
            self.embed_user_GMF = nn.Embedding(user_num, fn)
            self.embed_item_GMF = nn.Embedding(item_num, fn)
        self.mlp_layers = nn.ModuleList()
        self.mlp_norms = None
        if model != "GMF":
            self.embed_user_MLP = nn.Embedding(user_num, mlp_dim)
            self.embed_item_MLP = nn.Embedding(item_num, mlp_dim)
            # Halving tower fn * 2^(nl - i) -> half (reference ncf/models.py:64-72).
            sizes = [fn * 2 ** (nl - i) for i in range(nl)]
            self.mlp_layers = nn.ModuleList(nn.Linear(s, s // 2) for s in sizes)
            if use_layer_norm:
                self.mlp_norms = nn.ModuleList(
                    nn.LayerNorm(s // 2, eps=layer_norm_eps) for s in sizes
                )
        predict_in = 2 * fn if model in ("NeuMF-end", "NeuMF-pre") else fn
        self.predict_layer = nn.Linear(predict_in, 1)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's initialisers, from a CPU ``generator``, in
        module order."""
        for mod in self.modules():
            if isinstance(mod, nn.Embedding):
                normal_(mod.weight, 0.01, generator)
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        for layer in self.mlp_layers:
            xavier_uniform_(layer.weight, generator)
            layer.bias.zero_()
        w = self.predict_layer.weight
        uniform_(w, math.sqrt(3.0 / w.shape[1]), generator)
        self.predict_layer.bias.zero_()

    def forward(
        self,
        user: torch.Tensor,
        item: torch.Tensor,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Score (user, item) pairs → logits of ``user``'s shape."""
        outputs = []
        if self.model != "MLP":
            gmf = self.embed_user_GMF(user) * self.embed_item_GMF(item)
            outputs.append(dropout(gmf, self.emb_dropout, deterministic, generator))
        if self.model != "GMF":
            x = torch.cat([self.embed_user_MLP(user), self.embed_item_MLP(item)], dim=-1)
            x = dropout(x, self.emb_dropout, deterministic, generator)
            for i, layer in enumerate(self.mlp_layers):
                x = dropout(layer(x), self.dropout, deterministic, generator)
                if self.mlp_norms is not None:
                    x = self.mlp_norms[i](x)
                x = torch.relu(x)
            outputs.append(x)
        concat = outputs[0] if len(outputs) == 1 else torch.cat(outputs, dim=-1)
        return self.predict_layer(concat)[..., 0]


def fuse_neumf_params(
    neumf: Dict[str, torch.Tensor],
    gmf: Dict[str, torch.Tensor],
    mlp: Dict[str, torch.Tensor],
    alpha: float = 0.5,
) -> Dict[str, torch.Tensor]:
    """NeuMF-pre parameters from trained GMF and MLP state dicts
    (reference ncf/models.py:88-126): the four embedding tables and the
    Dense tower layers are copied; the LayerNorms of a ``use_layer_norm``
    tower keep NeuMF-pre's fresh values (the reference copies only
    ``nn.Linear`` layers); the predict layer becomes [alpha · W_gmf,
    (1 - alpha) · W_mlp] with the blended bias."""
    out = dict(neumf)
    for name in ("embed_user_GMF", "embed_item_GMF"):
        out[f"{name}.weight"] = gmf[f"{name}.weight"].clone()
    for key, value in mlp.items():
        if key.startswith(("embed_user_MLP.", "embed_item_MLP.", "mlp_layers.")):
            out[key] = value.clone()
    out["predict_layer.weight"] = torch.cat(
        [alpha * gmf["predict_layer.weight"], (1 - alpha) * mlp["predict_layer.weight"]],
        dim=1,
    )
    out["predict_layer.bias"] = (
        alpha * gmf["predict_layer.bias"] + (1 - alpha) * mlp["predict_layer.bias"]
    )
    return out


def inject_item_embeddings(
    state: Dict[str, torch.Tensor],
    item_init_emb: np.ndarray,
    target: str = "embed_item_MLP",
) -> Dict[str, torch.Tensor]:
    """Put PMGT item embeddings into the ``target`` table of a state dict
    (reference ncf/trainer.py:168-180, dcn/trainer.py:127-139); the shapes
    must agree."""
    out = dict(state)
    table = out[f"{target}.weight"]
    emb = torch.as_tensor(np.asarray(item_init_emb), dtype=table.dtype)
    if tuple(emb.shape) != tuple(table.shape):
        raise ValueError(
            f"item embedding shape {tuple(emb.shape)} != table shape {tuple(table.shape)}"
        )
    out[f"{target}.weight"] = emb.to(table.device).clone()
    return out
