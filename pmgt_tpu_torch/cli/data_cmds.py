"""Data commands of the port's command line (counterpart of
``pmgt_tpu/cli/data_cmds.py``), with the JAX commands' options and
defaults:

- ``make-synthetic`` writes a synthetic dataset in the native artifact
  format, which both packages load;
- ``preprocess`` turns a raw review dump into native artifacts
  (``data/preprocess.run_preprocess``);
- ``scrape-images`` downloads the product images a metadata dump names
  (``data/ingest.py``).

Only ``preprocess --extract-features`` touches the card: its extractors
run on ``--feature-device`` (default: the command's ``--device``)."""
from __future__ import annotations

import argparse
import logging

from pmgt_tpu_torch.cli.main import _existing_path

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


def add_preprocess(sub) -> None:
    p = sub.add_parser(
        "preprocess",
        help="offline preprocessing: reviews -> item graph + splits + features",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    a = p.add_argument
    a("--raw-dir", required=True,
      help="directory with reviews.json[.gz] and optional metadata "
      "(created by --download when absent)")
    a("--out-dir", required=True)
    a("--dataset-name", required=True)
    a("--min-common-users", type=int, default=3)
    a("--split-date", default="2015-01-01")
    a("--test-size", type=float, default=0.2)
    a("--seed", type=int, default=0)
    a("--extract-features", action=argparse.BooleanOptionalAction, default=False,
      help="fill the feature tables with extracted features: from <out-dir>/"
      "<dataset-name>_{visual,textual}_feats.npz when present, else by the "
      "extractors (which write those files); a modality whose model cannot be "
      "had keeps random rows")
    a("--text-model", default="bert-base-uncased",
      help="textual extractor: a local transformers model directory (or a name in "
      "the local Hugging Face cache; nothing is downloaded)")
    a("--image-model", default="inception_v4",
      help="visual extractor: timm's pretrained model of this name (needs timm and "
      "its weights)")
    a("--feature-device", default=None,
      help="device of the extractors (default: the command's --device, so the card; "
      "the JAX command's default is the CPU)")
    a("--download", action="store_true",
      help="download the Amazon 5-core dump when reviews are absent")
    p.set_defaults(handler=preprocess)


def preprocess(ns: argparse.Namespace):
    """The artifacts, also saved under ``<out-dir>/<dataset-name>``."""
    from pmgt_tpu_torch.data.preprocess import run_preprocess

    return run_preprocess(
        raw_dir=ns.raw_dir,
        out_dir=ns.out_dir,
        dataset_name=ns.dataset_name,
        min_common_users=ns.min_common_users,
        split_date=ns.split_date,
        test_size=ns.test_size,
        seed=ns.seed,
        extract_features=ns.extract_features,
        text_model=ns.text_model,
        image_model=ns.image_model,
        feature_device=ns.feature_device or ns.device,
        download=ns.download,
    )


def add_scrape_images(sub) -> None:
    p = sub.add_parser(
        "scrape-images",
        help="parallel product-image download with exponential backoff",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    a = p.add_argument
    a("--meta-path", type=_existing_path, required=True,
      help="metadata dump (one JSON per line) with asin + image urls")
    a("--image-dir", required=True)
    a("--max-workers", type=int, default=8)
    a("--max-retries", type=int, default=4)
    a("--backoff", type=float, default=0.5)
    p.set_defaults(handler=scrape_images)


def scrape_images(ns: argparse.Namespace):
    """(downloaded or present, failed) counts over the image URLs."""
    from pmgt_tpu_torch.data import ingest

    urls = ingest.load_image_urls(ns.meta_path)
    logger.info("found image urls for %d items", len(urls))
    return ingest.scrape_images(
        urls,
        ns.image_dir,
        max_workers=ns.max_workers,
        max_retries=ns.max_retries,
        backoff=ns.backoff,
    )
