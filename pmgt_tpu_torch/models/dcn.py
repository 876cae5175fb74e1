"""Deep & Cross Network over (user, item) id pairs (counterpart of
``pmgt_tpu/models/dcn.py``; reference pmgt/dcn/models.py:13-183).

As in the JAX package: the reference's ``CrossLayer`` creates a bias but
never adds it, so the bias exists only with ``use_cross_bias``; the rank-1
cross ``(x0 x1ᵀ) w`` is computed as ``x0 · (x1 w)``.

``init_weights`` follows the JAX package's initialisers: embeddings
N(0, 1) (torch's ``nn.Embedding`` default, which the reference relies
on), cross weights and biases U(-1, 1), deep and output kernels flax's
lecun-normal, zero biases, unit LayerNorm scales. Dropout (flax's, from an
explicit ``torch.Generator``) is drawn in this order: the embedding
dropout, each cross layer's, each deep layer's.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from pmgt_tpu_torch.models.initializers import lecun_normal_, normal_, uniform_
from pmgt_tpu_torch.models.pmgt import dropout


class CrossLayer(nn.Module):
    def __init__(self, hidden_size: int, dropout: float = 0.0,
                 use_layer_norm: bool = False, layer_norm_eps: float = 1e-12,
                 use_cross_bias: bool = False):
        super().__init__()
        self.dropout = dropout
        self.weight = nn.Parameter(torch.zeros(hidden_size, 1))
        self.bias = nn.Parameter(torch.zeros(hidden_size)) if use_cross_bias else None
        self.norm = nn.LayerNorm(hidden_size, eps=layer_norm_eps) if use_layer_norm else None

    def forward(self, x0, x1, deterministic=True, generator=None):
        out = x0 * (x1 @ self.weight)  # rank-1 cross without the outer product
        if self.bias is not None:
            out = out + self.bias
        out = dropout(out, self.dropout, deterministic, generator) + x0
        return self.norm(out) if self.norm is not None else out


class CrossNet(nn.Module):
    def __init__(self, input_size: int, num_layers: int, dropout: float = 0.0,
                 use_layer_norm: bool = False, layer_norm_eps: float = 1e-12,
                 use_cross_bias: bool = False):
        super().__init__()
        self.layers = nn.ModuleList(
            CrossLayer(input_size, dropout, use_layer_norm, layer_norm_eps, use_cross_bias)
            for _ in range(num_layers)
        )

    def forward(self, x, deterministic=True, generator=None):
        x1 = x
        for layer in self.layers:
            x1 = layer(x, x1, deterministic, generator)
        return x1


class DeepNet(nn.Module):
    def __init__(self, input_size: int, linear_sizes, dropout: float = 0.0,
                 use_layer_norm: bool = False, layer_norm_eps: float = 1e-12):
        super().__init__()
        self.dropout = dropout
        sizes = [input_size, *linear_sizes]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(sizes, sizes[1:]))
        self.norms = (nn.ModuleList(nn.LayerNorm(s, eps=layer_norm_eps) for s in linear_sizes)
                      if use_layer_norm else None)

    def forward(self, x, deterministic=True, generator=None):
        for i, layer in enumerate(self.layers):
            x = dropout(layer(x), self.dropout, deterministic, generator)
            if self.norms is not None:
                x = self.norms[i](x)
            x = torch.relu(x)
        return x


class DCN(nn.Module):
    """Embedding concat → parallel CrossNet and DeepNet → concat → linear
    (reference dcn/models.py:125-183)."""

    def __init__(
        self,
        user_num: int,
        item_num: int,
        factor_num: int = 32,
        deep_net_num_layers: int = 3,
        cross_net_num_layers: int = 2,
        emb_dropout: float = 0.0,
        dropout: float = 0.0,
        use_layer_norm: bool = False,
        layer_norm_eps: float = 1e-12,
        use_cross_bias: bool = False,
    ):
        super().__init__()
        self.emb_dropout = emb_dropout
        input_size = factor_num * 2 ** deep_net_num_layers
        self.user_embeddings = nn.Embedding(user_num, input_size)
        self.item_embeddings = nn.Embedding(item_num, input_size)
        # Halving widths fn * 2^(L+1-i), i = 1..L (reference dcn/models.py:148-151).
        linear_sizes = [factor_num * 2 ** (deep_net_num_layers + 1 - i)
                        for i in range(1, deep_net_num_layers + 1)]
        self.deep_net = DeepNet(2 * input_size, linear_sizes, dropout,
                                use_layer_norm, layer_norm_eps)
        self.cross_net = CrossNet(2 * input_size, cross_net_num_layers, dropout,
                                  use_layer_norm, layer_norm_eps, use_cross_bias)
        self.output_layer = nn.Linear(2 * input_size + linear_sizes[-1], 1)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's initialisers, from a CPU ``generator``."""
        normal_(self.user_embeddings.weight, 1.0, generator)
        normal_(self.item_embeddings.weight, 1.0, generator)
        for layer in self.cross_net.layers:
            uniform_(layer.weight, 1.0, generator)
            if layer.bias is not None:
                uniform_(layer.bias, 1.0, generator)
        for lin in (*self.deep_net.layers, self.output_layer):
            lecun_normal_(lin.weight, generator)
            lin.bias.zero_()
        for mod in self.modules():
            if isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()

    def forward(
        self,
        user: torch.Tensor,
        item: torch.Tensor,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        x = torch.cat([self.user_embeddings(user), self.item_embeddings(item)], dim=-1)
        x = dropout(x, self.emb_dropout, deterministic, generator)
        cross = self.cross_net(x, deterministic, generator)
        deep = self.deep_net(x, deterministic, generator)
        return self.output_layer(torch.cat([cross, deep], dim=-1))[..., 0]
