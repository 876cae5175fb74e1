"""Raw-data ingestion: the Amazon review dump's download and product-image
scraping (counterpart of ``pmgt_tpu/data/ingest.py``), on ``urllib`` from
the standard library.

Behavioural reference: the reference notebook's cells 4 (dataset download
from the deepyeti mirror) and 12 (parallel image download with exponential
backoff). Both take an injectable ``opener`` so tests run without a
network.
"""
from __future__ import annotations

import gzip
import json
import logging
import os
import shutil
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Tuple

logger = logging.getLogger("pmgt_tpu_torch")

_MIRROR = "http://deepyeti.ucsd.edu/jianmo/amazon/categoryFilesSmall"
# Short names used throughout the reference (README.md:129-167).
_CATEGORIES = {
    "VG": "Video_Games",
    "TG": "Toys_and_Games",
}
_IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".gif", ".bmp", ".webp")


def download_reviews(
    dataset_name: str,
    raw_dir: str,
    opener: Callable = urllib.request.urlopen,
) -> str:
    """Fetch the 5-core review dump for ``dataset_name`` into
    ``<raw_dir>/reviews.json.gz`` (notebook cell 4). Idempotent: an
    existing file is kept as-is.

    ``dataset_name`` is either a short name (VG, TG) or a full category
    stem (e.g. ``Video_Games``).
    """
    os.makedirs(raw_dir, exist_ok=True)
    out_path = os.path.join(raw_dir, "reviews.json.gz")
    src_path = out_path + ".source"
    category = _CATEGORIES.get(dataset_name, dataset_name)
    url = f"{_MIRROR}/{category}_5.json.gz"
    if os.path.exists(out_path):
        # A sidecar records which dump this is, so reusing one raw_dir for
        # a different dataset fails loudly instead of silently building
        # artifacts from the wrong category's reviews.
        if os.path.exists(src_path):
            recorded = open(src_path).read().strip()
            if recorded != url:
                raise ValueError(
                    f"{out_path} holds {recorded}, but dataset "
                    f"{dataset_name} needs {url}; use a separate raw dir"
                )
        logger.info("reviews dump already present at %s", out_path)
        return out_path
    logger.info("downloading %s", url)
    tmp = out_path + ".part"
    # Stream to disk: full-category 5-core dumps reach GBs — buffering
    # the whole response in one bytes object can OOM a small
    # preprocessing host. Same atomic .part/os.replace protocol.
    with opener(url) as resp, open(tmp, "wb") as f:
        shutil.copyfileobj(resp, f)
    os.replace(tmp, out_path)
    with open(src_path, "w") as f:
        f.write(url)
    return out_path


def load_image_urls(meta_path: str) -> Dict[str, List[str]]:
    """Parse a product-metadata dump (one JSON object per line) into
    {asin: [image urls]} (notebook cell 12 reads ``imUrl``; newer dumps
    use ``imageURL`` / ``imageURLHighRes`` lists). Unparseable lines and
    items without images are skipped.
    """
    opener = gzip.open if meta_path.endswith(".gz") else open
    urls: Dict[str, List[str]] = {}
    with opener(meta_path, "rt") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except ValueError:  # json.JSONDecodeError is a ValueError
                continue
            asin = row.get("asin")
            if not asin:
                continue
            found: List[str] = []
            for field in ("imageURLHighRes", "imageURL", "imUrl"):
                val = row.get(field)
                if isinstance(val, str) and val:
                    found = [val]
                elif isinstance(val, list) and val:
                    found = [u for u in val if isinstance(u, str) and u]
                if found:
                    break
            if found:
                urls[asin] = found
    return urls


def _url_ext(url: str) -> str:
    base = url.split("?", 1)[0].rsplit("/", 1)[-1]
    _, dot, ext = base.rpartition(".")
    ext = ("." + ext.lower()) if dot else ""
    return ext if ext in _IMAGE_EXTS else ".jpg"


def scrape_images(
    urls: Dict[str, List[str]],
    image_dir: str,
    max_workers: int = 8,
    max_retries: int = 4,
    backoff: float = 0.5,
    opener: Callable = urllib.request.urlopen,
    sleep: Callable[[float], None] = time.sleep,
) -> Tuple[int, int]:
    """Download every image to ``<image_dir>/<asin>/<idx><ext>`` with a
    thread pool and per-URL exponential backoff (notebook cell 12's retry
    loop). Existing files are skipped (idempotent, counted as done).

    Returns (downloaded_or_present, failed) counts over URLs.
    """

    def fetch_one(asin: str, idx: int, url: str) -> bool:
        dest_dir = os.path.join(image_dir, asin)
        dest = os.path.join(dest_dir, f"{idx}{_url_ext(url)}")
        if os.path.exists(dest):
            return True
        os.makedirs(dest_dir, exist_ok=True)
        for attempt in range(max_retries):
            try:
                with opener(url, timeout=30) as resp:
                    data = resp.read()
                tmp = dest + ".part"
                with open(tmp, "wb") as f:
                    f.write(data)
                os.replace(tmp, dest)
                return True
            except Exception as exc:  # noqa: BLE001 — any fetch error retries
                if attempt + 1 >= max_retries:
                    logger.warning("giving up on %s: %s", url, exc)
                    return False
                sleep(backoff * (2 ** attempt))
        return False

    jobs = [
        (asin, idx, url)
        for asin, item_urls in urls.items()
        for idx, url in enumerate(item_urls)
    ]
    done = failed = 0
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        for ok in pool.map(lambda j: fetch_one(*j), jobs):
            if ok:
                done += 1
            else:
                failed += 1
    logger.info("scraped %d images (%d failed)", done, failed)
    return done, failed
