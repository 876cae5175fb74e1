"""Data commands of the port's command line (counterpart of
``pmgt_tpu/cli/data_cmds.py``): ``make-synthetic`` writes a synthetic
dataset in the native artifact format, which both packages load."""
from __future__ import annotations

import argparse
import logging

logger = logging.getLogger("pmgt_tpu_torch")


def add_make_synthetic(sub) -> None:
    p = sub.add_parser(
        "make-synthetic",
        help="generate a synthetic dataset in the native artifact format",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    a = p.add_argument
    a("--out-dir", required=True)
    a("--num-nodes", type=int, default=2000)
    a("--num-users", type=int, default=5000)
    a("--visual-dim", type=int, default=1536)
    a("--textual-dim", type=int, default=768)
    a("--avg-degree", type=int, default=16)
    a("--interactions-per-user", type=int, default=12)
    a("--seed", type=int, default=0)
    a("--shape", choices=("VG", "TG"), default=None,
      help="generate at the published scale and sparsity of the VG or TG "
      "dataset; overrides the count options")
    a("--signal", type=float, default=1.0,
      help="graph-to-interaction signal strength of --shape datasets")
    p.set_defaults(handler=make_synthetic)


def make_synthetic(ns: argparse.Namespace) -> None:
    from pmgt_tpu_torch.data.artifacts import save_native
    from pmgt_tpu_torch.data.synthetic import (
        make_published_shape_dataset,
        make_synthetic_dataset,
    )

    if ns.signal != 1.0 and not ns.shape:
        raise SystemExit("--signal applies only to --shape datasets")
    feat_dims = (ns.visual_dim, ns.textual_dim)
    if ns.shape:
        art = make_published_shape_dataset(
            ns.shape, feat_dims=feat_dims, seed=ns.seed, signal=ns.signal
        )
    else:
        art = make_synthetic_dataset(
            num_nodes=ns.num_nodes,
            num_users=ns.num_users,
            feat_dims=feat_dims,
            avg_degree=ns.avg_degree,
            interactions_per_user=ns.interactions_per_user,
            seed=ns.seed,
        )
    save_native(ns.out_dir, art)
    logger.info(
        "wrote synthetic dataset to %s (%d nodes, %d users, %d train pairs)",
        ns.out_dir,
        art.num_nodes,
        art.num_users,
        len(art.train_pairs),
    )
