"""Flax → PyTorch parameter conversion for the port's models.

Each converter takes the JAX package's parameter tree (nested dicts of
arrays, ``variables["params"]`` of the flax module) and returns a
``state_dict`` for this package's model (float32 CPU tensors):

- Dense ``kernel [in, out]`` → ``weight [out, in]``; ``bias`` → ``bias``
- LayerNorm ``scale`` / ``bias`` → ``weight`` / ``bias``
- Embed ``embedding`` → ``weight``
- ``position_embeddings`` / ``role_embeddings``, the relative-position
  ``distance_embedding`` of each layer and DCN's cross ``weight [H, 1]``
  as they are

A tree from ``nn.remat`` layers (gradient checkpointing) has the same
names, so it converts the same way.

``params_from_flax`` (``PMGTForPreTraining``), ``ncf_params_from_flax``
(``NCF``), ``dcn_params_from_flax`` (``DCN``) and
``pmgt_ncf_params_from_flax`` (``PMGT_NCF``, whose ``bert`` subtree maps
as the pre-training model's) raise on a missing or an extra leaf, so a
tree of another architecture cannot load half-way (a pruned tree loads
into a model built from the pruned config).
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

_DENSE = {"kernel": "weight", "bias": "bias"}
_NORM = {"scale": "weight", "bias": "bias"}
_LAYER_DENSE = (
    "self_attention/query",
    "self_attention/key",
    "self_attention/value",
    "self_attention/ctx_attention",
    "attention_output",
    "intermediate",
    "output",
)
_LAYER_NORMS = ("attention_norm", "output_norm")


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, path + "/"))
        else:
            out[path] = v
    return out


def _indices(paths, pattern: str):
    found = set()
    for p in paths:
        m = re.match(pattern, p)
        if m:
            found.add(int(m.group(1)))
    return sorted(found)


class _Mapping(dict):
    """flax path -> (torch name, transpose?)."""

    def dense(self, src, dst):
        for f, t in _DENSE.items():
            self[f"{src}/{f}"] = (f"{dst}.{t}", f == "kernel")

    def norm(self, src, dst):
        for f, t in _NORM.items():
            self[f"{src}/{f}"] = (f"{dst}.{t}", False)

    def embed(self, src, dst):
        self[f"{src}/embedding"] = (f"{dst}.weight", False)


def _bert(mapping: _Mapping, flat) -> int:
    """The ``bert`` subtree (``PMGTModel``); returns its modality count."""
    n_feats = len(_indices(flat, r"bert/embeddings/feat_linear_(\d+)/"))
    n_layers = len(_indices(flat, r"bert/layer_(\d+)/"))
    # relative positions: a distance embedding in every layer (judged by
    # the first layer, so a stray leaf elsewhere is reported as extra)
    relative = "bert/layer_0/self_attention/distance_embedding" in flat
    emb = "bert/embeddings"
    for i in range(n_feats):
        mapping.dense(f"{emb}/feat_linear_{i}", f"bert.embeddings.feat_linear.{i}")
    mapping.dense(f"{emb}/modality_attention", "bert.embeddings.modality_attention")
    mapping.norm(f"{emb}/norm", "bert.embeddings.norm")
    for name in ("position_embeddings", "role_embeddings"):
        mapping[f"{emb}/{name}"] = (f"bert.embeddings.{name}", False)
    for i in range(n_layers):
        for sub in _LAYER_DENSE:
            mapping.dense(f"bert/layer_{i}/{sub}",
                          f"bert.layers.{i}.{sub.replace('/', '.')}")
        for sub in _LAYER_NORMS:
            mapping.norm(f"bert/layer_{i}/{sub}", f"bert.layers.{i}.{sub}")
        if relative:
            mapping[f"bert/layer_{i}/self_attention/distance_embedding"] = (
                f"bert.layers.{i}.self_attention.distance_embedding", False)
    return n_feats


def _convert(flat, mapping: _Mapping, what: str) -> Dict[str, torch.Tensor]:
    missing = sorted(set(mapping) - set(flat))
    extra = sorted(set(flat) - set(mapping))
    if missing or extra:
        raise ValueError(
            f"flax tree does not match {what}: missing {missing}, extra {extra}"
        )
    state = {}
    for src, (dst, transpose) in mapping.items():
        a = np.asarray(flat[src], dtype=np.float32)
        # np.array copies: the tensor owns writable memory.
        state[dst] = torch.from_numpy(np.array(a.T if transpose else a, order="C"))
    return state


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax ``PMGTForPreTraining`` tree → the port's state dict."""
    flat = _flatten(tree)
    mapping = _Mapping()
    for i in range(_bert(mapping, flat)):
        mapping.dense(f"nfr_projection_{i}", f"nfr_projections.{i}")
    return _convert(flat, mapping, "PMGTForPreTraining")


def ncf_params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax ``NCF`` tree (any variant, with or without layer norm) →
    the port's ``NCF`` state dict."""
    flat = _flatten(tree)
    mapping = _Mapping()
    for name in ("embed_user_GMF", "embed_item_GMF", "embed_user_MLP", "embed_item_MLP"):
        if f"{name}/embedding" in flat:
            mapping.embed(name, name)
    for i in _indices(flat, r"mlp_(\d+)/"):
        mapping.dense(f"mlp_{i}", f"mlp_layers.{i}")
    for i in _indices(flat, r"mlp_norm_(\d+)/"):
        mapping.norm(f"mlp_norm_{i}", f"mlp_norms.{i}")
    mapping.dense("predict_layer", "predict_layer")
    return _convert(flat, mapping, "NCF")


def dcn_params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax ``DCN`` tree → the port's ``DCN`` state dict."""
    flat = _flatten(tree)
    mapping = _Mapping()
    mapping.embed("user_embeddings", "user_embeddings")
    mapping.embed("item_embeddings", "item_embeddings")
    for i in _indices(flat, r"deep_net/deep_(\d+)/"):
        mapping.dense(f"deep_net/deep_{i}", f"deep_net.layers.{i}")
    for i in _indices(flat, r"deep_net/deep_norm_(\d+)/"):
        mapping.norm(f"deep_net/deep_norm_{i}", f"deep_net.norms.{i}")
    for i in _indices(flat, r"cross_net/cross_(\d+)/"):
        src, dst = f"cross_net/cross_{i}", f"cross_net.layers.{i}"
        mapping[f"{src}/weight"] = (f"{dst}.weight", False)
        if f"{src}/bias" in flat:
            mapping[f"{src}/bias"] = (f"{dst}.bias", False)
        if f"{src}/LayerNorm_0/scale" in flat:
            mapping.norm(f"{src}/LayerNorm_0", f"{dst}.norm")
    mapping.dense("output_layer", "output_layer")
    return _convert(flat, mapping, "DCN")


def pmgt_ncf_params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax ``PMGT_NCF`` tree (MLP or NeuMF-end) → the port's
    ``PMGT_NCF`` state dict."""
    flat = _flatten(tree)
    mapping = _Mapping()
    _bert(mapping, flat)
    mapping.embed("mlp_user_embeddings", "mlp_user_embeddings")
    for i in _indices(flat, r"mlp_(\d+)/"):
        mapping.dense(f"mlp_{i}", f"mlp_layers.{i}")
    for name in ("gmf_user_embeddings", "gmf_item_embeddings"):
        if f"{name}/embedding" in flat:
            mapping.embed(name, name)
    mapping.dense("predict_layer", "predict_layer")
    return _convert(flat, mapping, "PMGT_NCF")
