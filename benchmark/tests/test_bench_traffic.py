"""The inputs repeat for a seed, and every seed gives the same sizes."""
from __future__ import annotations

import numpy as np

from benchmark.harness import common
from benchmark.tests import tiny
from benchmark.yardstick import tgdata


def _cfg():
    return dict(tiny.TINY_SIZES, signal=0.5)


def test_dataset_repeats():
    a, b = common.dataset(_cfg(), 2**31 + 7), common.dataset(_cfg(), 2**31 + 7)
    assert np.array_equal(a.edges, b.edges) and np.array_equal(a.train_pairs, b.train_pairs)
    assert all(np.array_equal(x, y) for x, y in zip(a.feat_tables, b.feat_tables))


def test_every_seed_the_same_sizes():
    shapes = {(len(d.edges), len(d.train_pairs), len(d.test_pairs), d.feat_tables[0].shape)
              for d in (common.dataset(_cfg(), s) for s in (1, 99, 2**33 + 5))}
    assert len(shapes) == 1


def test_frozen_generator_matches_the_published_shape_counts():
    d = tgdata.make_dataset(tiny.TINY_DATA, 0, 0.5, feat_dims=(8, 4))
    assert len(d.edges) == tiny.TINY_DATA["num_edges"]
    assert len(d.train_pairs) + len(d.test_pairs) == tiny.TINY_DATA["num_interactions"]


def test_user_streams_repeat():
    from benchmark.harness import spec

    drv = spec.load_driver("pmgt_ncf_serve")
    for how, k in (("permutation", 64), ("uniform", 1)):
        a, b = drv._Stream(1000, k, how, 5), drv._Stream(1000, k, how, 5)
        assert all(np.array_equal(a.next(), b.next()) for _ in range(20))


def test_weights_repeat():
    cfg = tiny.tiny_cell("pmgt-tg.pretrain").config
    shapes = common.pretrain_shapes(cfg)
    a, b = common.make_weights(shapes, cfg, 3, "cpu"), common.make_weights(shapes, cfg, 3, "cpu")
    assert all(bool((a[n] == b[n]).all()) for n in a)
