"""The port's reference-format loader (``load_artifacts`` on a
``graph.gpickle`` + joblib encoders + ``*_init_emb.npy`` + ``train.json``
/ ``test.json`` directory) against the JAX package's, on the miniature
reference dataset ``tests/fixtures/ref_mini/data/MINI``: the graph arrays
(with the alias tables), the feature tables, the pairs, the counts and
the label classes are equal."""
import os
import shutil

import numpy as np
import pytest

from pmgt_tpu.data.artifacts import load_artifacts as jax_load
from pmgt_tpu_torch.data.artifacts import load_artifacts, load_node_init_emb

DATA = os.path.join(os.path.dirname(__file__), "fixtures", "ref_mini", "data")
# (the JAX package's flat alias triple is a placeholder under its packed
# TPU row layouts, so the tables it is derived from are compared)
GRAPH_FIELDS = ("nbr_ids", "nbr_logits", "degrees", "alias_prob", "alias_idx",
                "nbr_sorted")


@pytest.fixture(scope="module")
def both():
    return jax_load(DATA, "MINI"), load_artifacts(DATA, "MINI")


def test_graph_equals_the_jax_loaders(both):
    j, t = both
    assert t.num_nodes == j.num_nodes == j.graph.num_nodes
    for name in GRAPH_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(t.graph, name)),
                                      np.asarray(getattr(j.graph, name)), err_msg=name)


def test_tables_pairs_counts_and_classes_equal(both):
    j, t = both
    assert len(t.feat_init_embs) == 2
    for a, b in zip(t.feat_init_embs, j.feat_init_embs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for name in ("train_pairs", "test_pairs"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert (t.num_users, t.num_items) == (j.num_users, j.num_items)
    assert t.item_classes.tolist() == j.item_classes.tolist()
    assert t.node_classes.tolist() == j.node_classes.tolist()
    # the node-to-item remap of the downstream tasks works on these classes
    emb = np.arange(t.num_nodes * 3, dtype=np.float32).reshape(t.num_nodes, 3)
    out = load_node_init_emb(t.item_classes, t.node_classes, emb)
    assert out.shape == (t.num_items, 3)


def test_native_layout_wins_and_missing_layout_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="graph.gpickle"):
        load_artifacts(str(tmp_path), "MINI")
    shutil.copytree(os.path.join(DATA, "MINI"), tmp_path / "MINI")
    (tmp_path / "MINI" / "graph.gpickle").unlink()
    with pytest.raises(FileNotFoundError):
        load_artifacts(str(tmp_path), "MINI")
