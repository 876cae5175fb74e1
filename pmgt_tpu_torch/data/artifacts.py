"""Dataset artifact container and the native on-disk format (counterpart
of ``pmgt_tpu/data/artifacts.py``).

The native format is compressed npz + json: the padded-CSR graph, the
init embedding tables, the interaction splits and metadata. The same
files load in both packages. The reference-format loader
(``graph.gpickle`` + joblib encoders) is not ported yet.

``load_node_init_emb`` maps an exported PMGT node-embedding table into the
downstream tasks' item-id space.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from pmgt_tpu_torch.graph.container import PaddedGraph

_META_FILE = "meta.json"
_NATIVE_FORMAT = "pmgt_tpu-native-v1"


@dataclass
class DatasetArtifacts:
    """Everything a workload needs, in memory.

    Node ids: 0 = <pad>, 1 = <mask>, real nodes 2..N+1. ``feat_init_embs``
    tables have N+2 rows with rows 0/1 zeroed. ``train_pairs`` /
    ``test_pairs`` are (user, item) int32 pairs.
    """

    graph: PaddedGraph
    feat_init_embs: List[np.ndarray]
    train_pairs: np.ndarray
    test_pairs: np.ndarray
    num_users: int
    num_items: int
    item_classes: Optional[np.ndarray] = None
    node_classes: Optional[np.ndarray] = None

    @property
    def num_nodes(self) -> int:
        return self.graph.num_nodes


def save_native(out_dir: str, art: DatasetArtifacts) -> None:
    """Write artifacts in the native format under ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    art.graph.save(os.path.join(out_dir, "graph.npz"))
    np.savez_compressed(
        os.path.join(out_dir, "init_embs.npz"),
        **{
            f"feat_{i}": np.asarray(t, np.float32)
            for i, t in enumerate(art.feat_init_embs)
        },
    )
    np.savez_compressed(
        os.path.join(out_dir, "interactions.npz"),
        train_pairs=np.asarray(art.train_pairs, np.int32),
        test_pairs=np.asarray(art.test_pairs, np.int32),
    )
    if art.item_classes is not None and art.node_classes is not None:
        np.savez_compressed(
            os.path.join(out_dir, "classes.npz"),
            item_classes=np.asarray(art.item_classes).astype(str),
            node_classes=np.asarray(art.node_classes).astype(str),
        )
    with open(os.path.join(out_dir, _META_FILE), "w") as f:
        json.dump(
            {
                "format": _NATIVE_FORMAT,
                "num_users": int(art.num_users),
                "num_items": int(art.num_items),
                "num_nodes": int(art.num_nodes),
            },
            f,
        )


def _load_native(d: str) -> DatasetArtifacts:
    with open(os.path.join(d, _META_FILE)) as f:
        meta = json.load(f)
    graph = PaddedGraph.load(os.path.join(d, "graph.npz"))
    with np.load(os.path.join(d, "init_embs.npz")) as z:
        feats = [z[f"feat_{i}"] for i in range(len(z.files))]
    with np.load(os.path.join(d, "interactions.npz")) as z:
        train_pairs = z["train_pairs"]
        test_pairs = z["test_pairs"]
    item_classes = node_classes = None
    classes_path = os.path.join(d, "classes.npz")
    if os.path.exists(classes_path):
        with np.load(classes_path, allow_pickle=False) as z:
            item_classes = z["item_classes"]
            node_classes = z["node_classes"]
    return DatasetArtifacts(
        graph=graph,
        feat_init_embs=feats,
        train_pairs=train_pairs,
        test_pairs=test_pairs,
        num_users=int(meta["num_users"]),
        num_items=int(meta["num_items"]),
        item_classes=item_classes,
        node_classes=node_classes,
    )


def load_artifacts(data_dir: str, dataset_name: str) -> DatasetArtifacts:
    """Load ``<data_dir>/<dataset_name>`` in the native format."""
    d = os.path.join(data_dir, dataset_name)
    if os.path.exists(os.path.join(d, _META_FILE)):
        return _load_native(d)
    if os.path.exists(os.path.join(d, "graph.gpickle")):
        raise NotImplementedError(
            f"{d} holds reference-format artifacts; their loader is not "
            "ported yet"
        )
    raise FileNotFoundError(
        f"no dataset artifacts under {d}: expected native ({_META_FILE})"
    )


def load_node_init_emb(
    item_classes: Optional[np.ndarray],
    node_classes: Optional[np.ndarray],
    node_emb: np.ndarray,
    normalize: bool = False,
    seed: int = 0,
) -> np.ndarray:
    """Remap exported PMGT node embeddings ([num_nodes, d], node-id order)
    into item-id space (reference pmgt/pmgt/utils.py:15-40): with both
    label-class arrays, item i takes the row of the node with its label,
    and an item absent from the graph takes ``rng.normal(size=d)`` from
    ``np.random.default_rng(seed)``, drawn in item order; without them the
    table is used as it is. ``normalize`` divides every row by its L2 norm
    (at least 1e-12)."""
    node_emb = np.asarray(node_emb, np.float32)
    if item_classes is None or node_classes is None:
        out = node_emb.copy()
    else:
        rng = np.random.default_rng(seed)
        node_idx = {label: i for i, label in enumerate(np.asarray(node_classes).tolist())}
        out = np.empty((len(item_classes), node_emb.shape[1]), np.float32)
        for i, label in enumerate(np.asarray(item_classes).tolist()):
            row = node_idx.get(label)
            if row is None:
                out[i] = rng.normal(size=node_emb.shape[1]).astype(np.float32)
            else:
                out[i] = node_emb[row]
    if normalize:
        out = out / np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-12)
    return out
