"""Dataset artifact container and the native on-disk format (counterpart
of ``pmgt_tpu/data/artifacts.py``).

The native format is compressed npz + json: the padded-CSR graph, the
init embedding tables, the interaction splits and metadata. The same
files load in both packages. ``load_artifacts`` also reads the reference's
layout (``graph.gpickle`` + joblib label encoders + ``{visual,textual}_
init_emb.npy`` + ``train.json`` / ``test.json``) with numpy and the
standard library alone (the card machine has neither networkx, sklearn,
joblib nor pandas): the pickles go through ``read_reference_pickle``,
which builds only the networkx ``Graph``, sklearn ``LabelEncoder`` and
joblib array records of that layout (as plain attribute holders) and
numpy arrays, and refuses every other class, so reading a dataset runs
no code from it.

``load_node_init_emb`` maps an exported PMGT node-embedding table into the
downstream tasks' item-id space.
"""
from __future__ import annotations

import json
import os
import pickle
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from pmgt_tpu_torch.graph.container import PaddedGraph, from_edges

try:  # numpy 2
    from numpy._core.multiarray import _reconstruct
except ImportError:  # numpy 1
    from numpy.core.multiarray import _reconstruct

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


class _Record:
    """An object of the reference layout rebuilt as its attributes."""


class _ArrayRecord(_Record):
    """joblib's ``NumpyArrayWrapper``: the raw array bytes follow it."""


# (module, name) -> what the restricted reader builds for it
_REFERENCE_CLASSES = {
    ("networkx.classes.graph", "Graph"): _Record,
    ("sklearn.preprocessing._label", "LabelEncoder"): _Record,
    ("joblib.numpy_pickle", "NumpyArrayWrapper"): _ArrayRecord,
    ("numpy", "ndarray"): np.ndarray,
    ("numpy", "dtype"): np.dtype,
    ("numpy.core.multiarray", "_reconstruct"): _reconstruct,
    ("numpy._core.multiarray", "_reconstruct"): _reconstruct,
}


class _ReferenceUnpickler(pickle._Unpickler):
    """pickle (protocol 2-5) limited to ``_REFERENCE_CLASSES``, reading
    joblib's arrays (a ``NumpyArrayWrapper`` record followed by the raw
    array bytes, after a padding byte count and the padding) as joblib's
    ``NumpyUnpickler`` does."""

    def __init__(self, file):
        super().__init__(file)
        self._raw = file

    def find_class(self, module, name):
        try:
            return _REFERENCE_CLASSES[(module, name)]
        except KeyError:
            raise pickle.UnpicklingError(f"{module}.{name} is not in the reference layout") from None

    def _read_joblib_array(self, w: _ArrayRecord) -> np.ndarray:
        dtype = np.dtype(w.dtype)
        if dtype.hasobject:
            return _ReferenceUnpickler(self._raw).load()
        if getattr(w, "numpy_array_alignment_bytes", None) is not None:
            pad = int.from_bytes(self._raw.read(1), "little")
            self._raw.read(pad)
        count = int(np.prod(w.shape, dtype=np.int64))
        data = self._raw.read(count * dtype.itemsize)
        if len(data) != count * dtype.itemsize:
            raise pickle.UnpicklingError("truncated joblib array")
        return np.frombuffer(data, dtype=dtype, count=count).copy().reshape(tuple(w.shape))

    def load_build(self):
        super().load_build()
        if isinstance(self.stack[-1], _ArrayRecord):
            self.stack[-1] = self._read_joblib_array(self.stack[-1])

    dispatch = dict(pickle._Unpickler.dispatch)
    dispatch[pickle.BUILD[0]] = load_build


def read_reference_pickle(path: str):
    """The reference layout's ``graph.gpickle`` or joblib encoder at
    ``path``, objects as ``_Record`` attribute holders; raises
    ``pickle.UnpicklingError`` on any class outside the layout."""
    with open(path, "rb") as f:
        return _ReferenceUnpickler(f).load()


def _graph_edges(g) -> List[tuple]:
    """(u, v, weight) of an undirected networkx graph's record, in the
    order ``Graph.edges(data=True)`` yields them."""
    seen, out = set(), []
    for u, nbrs in g._adj.items():
        for v, data in nbrs.items():
            if v not in seen:
                out.append((u, v, float(data.get("weight", 1.0))))
        seen.add(u)
    return out


def _encode(classes: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """``LabelEncoder.transform``: each label's index in the sorted
    ``classes``; an unknown label raises ``ValueError``."""
    idx = np.searchsorted(classes, labels)
    known = idx < len(classes)
    known[known] = classes[idx[known]] == labels[known]
    if not known.all():
        raise ValueError(f"unseen labels: {labels[~known][:5].tolist()}")
    return idx


def _read_pairs_json(path, user_classes, item_classes) -> np.ndarray:
    """A reviewerID/asin dataframe written by pandas' ``to_json``
    ({column: {row label: value}}, rows in file order) → (user, item)
    int32 pairs encoded by the run's label classes."""
    with open(path, encoding="utf-8") as f:
        df = json.load(f)
    users = np.asarray(list(df["reviewerID"].values()))
    items = np.asarray(list(df["asin"].values()))
    return np.stack([_encode(user_classes, users), _encode(item_classes, items)],
                    axis=1).astype(np.int32)


def _load_reference(d: str) -> DatasetArtifacts:
    """Load the reference's on-disk layout (module docstring). The graph's
    labelled nodes are relabelled through ``node_encoder`` to 0..N-1, then
    shifted by the two special ids inside ``from_edges``."""
    g, node_enc, user_enc, item_enc = (
        read_reference_pickle(os.path.join(d, n))
        for n in ("graph.gpickle", "node_encoder", "user_encoder", "item_encoder"))
    node_classes = np.asarray(node_enc.classes_)
    user_classes, item_classes = np.asarray(user_enc.classes_), np.asarray(item_enc.classes_)
    node_idx = {label: i for i, label in enumerate(node_classes.tolist())}
    edges = [(node_idx[u], node_idx[v], w) for u, v, w in _graph_edges(g)]
    graph = from_edges(len(node_classes), edges)

    feats = [
        np.load(os.path.join(d, f"{m}_init_emb.npy"))
        for m in ("visual", "textual")
    ]
    return DatasetArtifacts(
        graph=graph,
        feat_init_embs=feats,
        train_pairs=_read_pairs_json(os.path.join(d, "train.json"), user_classes, item_classes),
        test_pairs=_read_pairs_json(os.path.join(d, "test.json"), user_classes, item_classes),
        num_users=len(user_classes),
        num_items=len(item_classes),
        item_classes=item_classes,
        node_classes=node_classes,
    )


def load_artifacts(data_dir: str, dataset_name: str) -> DatasetArtifacts:
    """Load ``<data_dir>/<dataset_name>`` in whichever format is present."""
    d = os.path.join(data_dir, dataset_name)
    if os.path.exists(os.path.join(d, _META_FILE)):
        return _load_native(d)
    if os.path.exists(os.path.join(d, "graph.gpickle")):
        return _load_reference(d)
    raise FileNotFoundError(
        f"no dataset artifacts under {d}: expected native ({_META_FILE}) "
        "or reference (graph.gpickle) layout"
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
