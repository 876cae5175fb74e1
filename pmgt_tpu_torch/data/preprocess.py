"""Offline preprocessing pipeline: a raw review dump → the native dataset
artifacts (counterpart of ``pmgt_tpu/data/preprocess.py``; the reference
notebook's cells in parens).

1. optional dump download (4): ``pmgt_tpu_torch.data.ingest``;
2. temporal split at ``split_date`` (9): pre-cutoff reviews build the
   graph, post-cutoff reviews become downstream interactions;
3. item-item co-review graph (20): edges where at least
   ``min_common_users`` users reviewed both items, weight
   (log w + 1)/(log √(deg_u·deg_v) + 1). The pairs are counted by the
   native builder (``pmgt_tpu_torch/native/co_review.cpp``); the scipy
   sparse product ``co_review_edges_scipy`` is its plain version and
   takes over above the builder's ``max_pairs`` cap. The graph's alias
   tables come from the native alias builder;
4. label encoding (22, 26) and the random train/test interaction split
   (24, 28) of the post-cutoff pairs over graph items, by the numpy
   ``train_test_split`` of ``data/split.py`` (sklearn's split);
5. init embedding tables (30): rows 0/1 zeroed for <pad>/<mask>,
   random-normal rows for the nodes, from two generators
   ``default_rng([seed, 1])`` (visual) and ``default_rng([seed, 2])``
   (textual). With ``extract_features=True`` each modality's rows come
   from the pre-extracted drop-in ``<out_dir>/<dataset>_{visual,textual}_
   feats.npz`` when it is there, else from its extractor
   (``data/feature_extraction.py``: the item images under
   ``<raw_dir>/images`` through ``visual_model`` and ``visual_transform``,
   the pre-split review texts through ``text_model``, on
   ``feature_device``), which writes that file. A modality falls back to
   random rows, with the JAX package's warning, only when its extractor
   is unavailable (``ExtractorUnavailable``: package, weights or model
   path missing, or nothing to extract); any other error, on the device
   or in a model's forward pass, raises.

The artifacts equal the JAX package's bit for bit wherever no extractor
runs. Each stage's host time is logged (the record's ``stage_seconds``
attribute).
"""
from __future__ import annotations

import gzip
import json
import logging
import os
import time
from datetime import datetime, timezone
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from pmgt_tpu_torch.data.artifacts import DatasetArtifacts, save_native
from pmgt_tpu_torch.data.split import train_test_split
from pmgt_tpu_torch.graph.container import NUM_SPECIAL_NODES, from_edges

logger = logging.getLogger("pmgt_tpu_torch")


def _find_review_dumps(raw_dir: str) -> List[str]:
    """Review-dump candidates in ``raw_dir`` (json-lines, optionally
    gzipped; metadata dumps excluded), shared by ``_load_reviews`` and
    ``run_preprocess``'s download guard."""
    if not os.path.isdir(raw_dir):
        return []
    return [
        os.path.join(raw_dir, n)
        for n in sorted(os.listdir(raw_dir))
        if n.endswith((".json", ".json.gz")) and not n.startswith("meta")
    ]


def _load_reviews(
    raw_dir: str, keep_text: bool = False
) -> List[Tuple[str, str, float, str]]:
    """Stream the first reviews dump in ``raw_dir`` into compact (user,
    asin, timestamp, text) tuples; ``text`` is "" unless ``keep_text``.
    Unparseable lines and reviews without a user or an item are skipped."""
    candidates = _find_review_dumps(raw_dir)
    if not candidates:
        raise FileNotFoundError(f"no reviews dump (*.json[.gz]) in {raw_dir}")
    path = candidates[0]
    opener = gzip.open if path.endswith(".gz") else open
    reviews = []
    with opener(path, "rt") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except ValueError:  # json.JSONDecodeError is a ValueError
                continue
            user, asin = row.get("reviewerID"), row.get("asin")
            if not (user and asin):
                continue
            reviews.append(
                (
                    user,
                    asin,
                    float(row.get("unixReviewTime", 0)),
                    (row.get("reviewText") or "") if keep_text else "",
                )
            )
    logger.info("loaded %d reviews from %s", len(reviews), path)
    return reviews


def build_co_review_graph(
    reviews: Iterable[dict], min_common_users: int = 3
) -> Tuple[np.ndarray, List[Tuple[int, int, float]]]:
    """Item-item co-review graph of review dicts (``reviewerID``,
    ``asin``): (node_items: the sorted asins that kept an edge, edges:
    (u, v, weight) with indices into node_items)."""
    return _graph_from_pairs(
        {(r["reviewerID"], r["asin"]) for r in reviews}, min_common_users
    )


def co_review_edges_scipy(
    rows: np.ndarray, cols: np.ndarray, num_items: int, num_users: int,
    min_common: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The plain version of ``co_review_edges_native`` on deduplicated
    (item ``rows``, user ``cols``) records: the upper triangle of
    ``M @ Mᵀ`` of the item-user matrix, entries >= ``min_common``, in
    row-major order."""
    import scipy.sparse as sp

    mat = sp.csr_matrix(
        (np.ones(len(rows), np.int64), (rows, cols)),
        shape=(num_items, num_users),
    )
    co = sp.triu(mat @ mat.T, k=1).tocoo()
    keep = co.data >= min_common
    return co.row[keep], co.col[keep], co.data[keep]


def _graph_from_pairs(
    pairs, min_common_users: int, timings: Optional[Dict[str, float]] = None
) -> Tuple[np.ndarray, List[Tuple[int, int, float]]]:
    """The graph of a set of (user, asin) pairs; ``timings`` gets the
    label encoding's and the pair counting's host seconds."""
    if not pairs:
        return np.asarray([], dtype=object), []
    from pmgt_tpu_torch.native import co_review_edges_native

    t0 = time.perf_counter()
    users = sorted({u for u, _ in pairs})
    items = sorted({a for _, a in pairs})
    uidx = {u: i for i, u in enumerate(users)}
    iidx = {a: i for i, a in enumerate(items)}
    rows = np.asarray([iidx[a] for _, a in pairs], np.int32)
    cols = np.asarray([uidx[u] for u, _ in pairs], np.int32)
    t1 = time.perf_counter()
    native = co_review_edges_native(rows, cols, min_common_users)
    if native is not None:
        src, dst, counts = native
    else:  # above the builder's memory cap
        src, dst, counts = co_review_edges_scipy(
            rows, cols, len(items), len(users), min_common_users
        )
    t2 = time.perf_counter()

    raw_edges = {
        (int(u), int(v)): int(w) for u, v, w in zip(src, dst, counts)
    }
    deg = np.zeros(len(items), np.int64)
    for u, v in raw_edges:
        deg[u] += 1
        deg[v] += 1

    kept_items = np.asarray(
        [items[i] for i in range(len(items)) if deg[i] > 0], dtype=object
    )
    remap = {iidx[a]: k for k, a in enumerate(kept_items.tolist())}
    edges = [
        (
            remap[u],
            remap[v],
            float(
                (np.log(w) + 1.0)
                / (np.log(np.sqrt(deg[u] * deg[v])) + 1.0)
            ),
        )
        for (u, v), w in sorted(raw_edges.items())
    ]
    if timings is not None:
        timings["encode"] = t1 - t0
        timings["count_pairs"] = t2 - t1
        timings["weights"] = time.perf_counter() - t2
    return kept_items, edges


def _split_timestamp(split_date: str) -> float:
    return datetime.strptime(split_date, "%Y-%m-%d").replace(
        tzinfo=timezone.utc
    ).timestamp()


def _random_table(
    rng: np.random.Generator, num_nodes: int, dim: int
) -> np.ndarray:
    """Init table with zeroed special rows and random-normal node rows."""
    table = np.zeros((num_nodes + NUM_SPECIAL_NODES, dim), np.float32)
    table[NUM_SPECIAL_NODES:] = rng.normal(
        size=(num_nodes, dim)
    ).astype(np.float32)
    return table


def _fill_table(
    rng: np.random.Generator,
    num_nodes: int,
    node_idx: Dict[str, int],
    feats: np.ndarray,
    mapping: Sequence[str],
) -> np.ndarray:
    """Extracted rows over a random base (feature-less items keep random
    rows)."""
    table = _random_table(rng, num_nodes, feats.shape[1])
    for asin, row in zip(mapping, feats):
        idx = node_idx.get(asin)
        if idx is not None:
            table[NUM_SPECIAL_NODES + idx] = row
    return table


def _load_feats_npz(path: str):
    """The pre-extracted drop-in ``<out_dir>/<dataset>_{visual,textual}_
    feats.npz`` (keys ``feats`` [n, dim], ``asins`` [n]) as (feats,
    asins), or None when absent."""
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=True) as data:
        feats = np.asarray(data["feats"], np.float32)
        mapping = [str(a) for a in data["asins"].tolist()]
    logger.info(
        "using pre-extracted features from %s (%d items, %d-d); "
        "extraction skipped", path, len(mapping), feats.shape[1],
    )
    return feats, mapping


def _extract_visual(raw_dir, out_dir, dataset_name, image_model, device, visual_model,
                    visual_transform):
    """The visual drop-in file's features, else those extracted from the
    item images (and saved as that file)."""
    out_npz = os.path.join(out_dir, f"{dataset_name}_visual_feats.npz")
    seeded = _load_feats_npz(out_npz)
    if seeded is not None:
        return seeded
    from pmgt_tpu_torch.data import feature_extraction as fx

    images_dir = os.path.join(raw_dir, "images")
    feats, mapping = fx.extract_visual_features(
        fx.iter_item_images(images_dir), model=visual_model, transform=visual_transform,
        model_name=image_model, device=device)
    if not mapping:
        raise fx.ExtractorUnavailable(f"no item images under {images_dir}")
    fx.save_feats_npz(out_npz, feats, mapping)
    return feats, mapping


def _node_texts(pre, node_idx: Dict[str, int]) -> Dict[str, List[str]]:
    """The non-empty pre-split review texts of each graph item, in review
    order."""
    texts: Dict[str, List[str]] = {}
    for _, asin, _, text in pre:
        if text and asin in node_idx:
            texts.setdefault(asin, []).append(text)
    return texts


def _extract_textual(out_dir, dataset_name, node_texts, text_model, device):
    """The textual drop-in file's features, else those extracted from the
    review texts (and saved as that file)."""
    out_npz = os.path.join(out_dir, f"{dataset_name}_textual_feats.npz")
    seeded = _load_feats_npz(out_npz)
    if seeded is not None:
        return seeded
    from pmgt_tpu_torch.data import feature_extraction as fx

    feats, mapping = fx.extract_textual_features(node_texts, model_name=text_model,
                                                 device=device)
    if not mapping:
        raise fx.ExtractorUnavailable("no review texts to extract from")
    fx.save_feats_npz(out_npz, feats, mapping)
    return feats, mapping


def run_preprocess(
    raw_dir: str,
    out_dir: str,
    dataset_name: str,
    min_common_users: int = 3,
    split_date: str = "2015-01-01",
    test_size: float = 0.2,
    seed: int = 0,
    visual_dim: int = 1536,
    textual_dim: int = 768,
    extract_features: bool = False,
    text_model: str = "bert-base-uncased",
    image_model: str = "inception_v4",
    feature_device: str = "cuda",
    visual_model=None,
    visual_transform=None,
    download: bool = False,
) -> DatasetArtifacts:
    """Run the pipeline (module docstring) and return the artifacts, also
    saved natively under ``<out_dir>/<dataset_name>``. ``text_model`` is a
    local model directory (or a name in the local Hugging Face cache);
    ``visual_model`` (default: timm's ``image_model``) and
    ``visual_transform`` are the visual extractor's model and per-image
    transform; extraction runs on ``feature_device``."""
    os.makedirs(out_dir, exist_ok=True)
    if not (0 <= test_size < 1):
        raise ValueError(
            f"test_size must be in [0, 1), got {test_size} "
            f"(0 = no test split)"
        )
    if download and not _find_review_dumps(raw_dir):
        from pmgt_tpu_torch.data.ingest import download_reviews

        download_reviews(dataset_name, raw_dir)

    stages: Dict[str, float] = {}
    t = time.perf_counter()
    reviews = _load_reviews(raw_dir, keep_text=extract_features)
    cutoff = _split_timestamp(split_date)
    pre = [r for r in reviews if r[2] < cutoff]
    post = [r for r in reviews if r[2] >= cutoff]
    del reviews
    stages["read"] = time.perf_counter() - t
    logger.info(
        "temporal split at %s: %d graph reviews / %d interaction reviews",
        split_date,
        len(pre),
        len(post),
    )

    t = time.perf_counter()
    node_items, edges = _graph_from_pairs(
        {(u, a) for u, a, _, _ in pre}, min_common_users, stages
    )
    stages["graph_pairs_total"] = time.perf_counter() - t
    if not len(node_items):
        raise ValueError(
            "empty co-review graph: lower --min-common-users or check the "
            "temporal split"
        )
    node_idx = {a: i for i, a in enumerate(node_items.tolist())}
    t = time.perf_counter()
    graph = from_edges(len(node_items), edges)
    stages["from_edges_with_alias"] = time.perf_counter() - t

    t = time.perf_counter()
    inter = sorted(
        {(u, a) for u, a, _, _ in post if a in node_idx}
    )
    if not inter:
        raise ValueError("no post-split interactions over graph items")
    user_classes = np.asarray(sorted({u for u, _ in inter}), dtype=object)
    item_classes = np.asarray(sorted({a for _, a in inter}), dtype=object)
    u_enc = {u: i for i, u in enumerate(user_classes.tolist())}
    i_enc = {a: i for i, a in enumerate(item_classes.tolist())}
    pairs = np.asarray(
        [(u_enc[u], i_enc[a]) for u, a in inter], np.int32
    )
    if len(pairs) > 1 and 0 < test_size < 1:
        train_pairs, test_pairs = train_test_split(pairs, test_size, seed)
    else:
        train_pairs, test_pairs = pairs, pairs[:0]
    stages["split"] = time.perf_counter() - t

    # Independent per-modality streams, as the JAX package draws them.
    t = time.perf_counter()
    rng_v = np.random.default_rng([seed, 1])
    rng_t = np.random.default_rng([seed, 2])
    n = len(node_items)
    tables = []
    for modality, rng, dim in (("visual", rng_v, visual_dim), ("textual", rng_t, textual_dim)):
        if extract_features:
            from pmgt_tpu_torch.data.feature_extraction import ExtractorUnavailable

            try:
                if modality == "visual":
                    feats, mapping = _extract_visual(raw_dir, out_dir, dataset_name, image_model,
                                                     feature_device, visual_model,
                                                     visual_transform)
                else:
                    feats, mapping = _extract_textual(out_dir, dataset_name,
                                                      _node_texts(pre, node_idx), text_model,
                                                      feature_device)
                tables.append(_fill_table(rng, n, node_idx, feats, mapping))
                continue
            except ExtractorUnavailable as exc:  # the JAX package's fallback, narrowed
                logger.warning(
                    "%s extraction unavailable (%s); falling back to "
                    "random %d-d rows",
                    modality,
                    exc,
                    dim,
                )
        tables.append(_random_table(rng, n, dim))
    stages["tables"] = time.perf_counter() - t

    t = time.perf_counter()
    art = DatasetArtifacts(
        graph=graph,
        feat_init_embs=tables,
        train_pairs=np.ascontiguousarray(train_pairs),
        test_pairs=np.ascontiguousarray(test_pairs),
        num_users=len(user_classes),
        num_items=len(item_classes),
        item_classes=item_classes,
        node_classes=node_items,
    )
    save_native(os.path.join(out_dir, dataset_name), art)
    stages["save"] = time.perf_counter() - t
    logger.info(
        "preprocessed %s: %d nodes / %d edges, %d users, %d items, "
        "%d train / %d test pairs",
        dataset_name,
        n,
        len(edges),
        art.num_users,
        art.num_items,
        len(train_pairs),
        len(test_pairs),
    )
    logger.info("preprocess stage seconds: %s", json.dumps(stages),
                extra={"stage_seconds": stages})
    return art
