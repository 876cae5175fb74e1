"""Multimodal feature extraction: Inception-v4 visual and BERT textual
features per item (counterpart of ``pmgt_tpu/data/feature_extraction.py``;
the reference's preprocessing/datasets.py:28-84 and notebook cells 15 and
18).

- ``iter_item_images`` walks ``<images_dir>/<asin>/*`` in sorted order,
  skipping the scraper's ``.part`` files and unreadable images;
- ``extract_visual_features``: ``forward_features`` + ``global_pool`` per
  image, flattened, then the mean over an item's images;
- ``extract_textual_features``: the CLS row of ``last_hidden_state`` per
  review, in batches of 16 reviews of at most ``TEXT_MAX_LENGTH`` tokens,
  then the mean over an item's non-empty reviews.

Both return ``(feats [K, D] float32, asins)``, or ``(zeros((0, 0)), [])``
when there is nothing to extract. The models are injectable: any module
with timm's ``forward_features`` / ``global_pool`` surface, and any
encoder returning ``last_hidden_state`` with a tokenizer called as
Hugging Face's. Only the defaults (timm's pretrained ``inception_v4``,
``transformers``' ``bert-base-uncased``) and PIL are imported, lazily, on
the paths that need them; ``transformers`` loads only local files (a
model directory, or the local Hugging Face cache), where the JAX package
downloads. When such a model or package cannot be had
(the package is missing, the weights or model path are absent) the
loaders raise ``ExtractorUnavailable``; every other error, a device fault
or a model failing in its forward pass, propagates.

The device is explicit and, as everywhere in the port, defaults to the
card; pass ``device="cpu"`` for the CPU.
"""
from __future__ import annotations

import logging
import os
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

logger = logging.getLogger("pmgt_tpu_torch")

TEXT_MAX_LENGTH = 128  # reference preprocessing/datasets.py:80


class ExtractorUnavailable(RuntimeError):
    """A modality's extractor cannot run: its package, weights or model
    path are missing, or there is nothing to extract from."""


def default_image_transform(size: int = 299) -> Callable:
    """PIL image → float tensor [3, size, size], inception-style
    normalization ((x/255 - 0.5) / 0.5), deterministic resize."""

    def transform(img):
        img = img.convert("RGB").resize((size, size))
        arr = np.asarray(img, np.float32) / 255.0
        arr = (arr - 0.5) / 0.5
        return torch.from_numpy(arr.transpose(2, 0, 1))

    return transform


def iter_item_images(images_dir: str) -> Iterator[Tuple[str, List]]:
    """(asin, [PIL images]) for each ``<images_dir>/<asin>/`` with a
    readable image, asins and files in sorted order. A scraper's in-flight
    ``<img>.part`` file is skipped (its finished twin is already there),
    and so is a file PIL cannot read."""
    try:
        from PIL import Image
    except ImportError as exc:
        raise ExtractorUnavailable(f"reading item images needs PIL ({exc})") from exc

    if not os.path.isdir(images_dir):
        return
    for asin in sorted(os.listdir(images_dir)):
        item_dir = os.path.join(images_dir, asin)
        if not os.path.isdir(item_dir):
            continue
        images = []
        for name in sorted(os.listdir(item_dir)):
            if name.endswith(".part"):
                continue
            path = os.path.join(item_dir, name)
            try:
                with Image.open(path) as img:
                    images.append(img.convert("RGB"))
            except (OSError, SyntaxError, ValueError):  # corrupt downloads are expected
                logger.warning("skipping unreadable image %s", path)
        if images:
            yield asin, images


def load_visual_model(model_name: str = "inception_v4"):
    """timm's ``model_name`` with its pretrained weights."""
    try:
        import timm

        return timm.create_model(model_name, pretrained=True)
    except (ImportError, OSError) as exc:
        raise ExtractorUnavailable(f"visual model {model_name!r} unavailable ({exc})") from exc


def load_text_model(model_name: str = "bert-base-uncased", model=None, tokenizer=None):
    """(model, tokenizer): the given ones, the missing ones loaded by
    ``transformers`` from ``model_name``: a local directory, or a hub name
    already in the local Hugging Face cache (nothing is downloaded)."""
    if model is not None and tokenizer is not None:
        return model, tokenizer
    try:
        from transformers import AutoModel, AutoTokenizer

        if tokenizer is None:
            tokenizer = AutoTokenizer.from_pretrained(model_name, local_files_only=True)
        if model is None:
            model = AutoModel.from_pretrained(model_name, local_files_only=True)
    except (ImportError, OSError, ValueError) as exc:  # ValueError: not a path nor a hub name
        raise ExtractorUnavailable(f"text model {model_name!r} unavailable ({exc})") from exc
    return model, tokenizer


def extract_visual_features(
    item_images: Iterable[Tuple[str, Sequence]],
    model=None,
    transform: Optional[Callable] = None,
    model_name: str = "inception_v4",
    device: str = "cuda",
) -> Tuple[np.ndarray, List[str]]:
    """Per-item visual features: ``forward_features`` + ``global_pool``
    per image, flattened, mean over the item's images. ``model`` None
    loads timm's pretrained ``model_name``; ``transform`` maps one image
    to a [3, H, W] tensor (default: ``default_image_transform()``).
    Returns (features [K, D] float32, asins in iteration order)."""
    if model is None:
        model = load_visual_model(model_name)
    if transform is None:
        transform = default_image_transform()
    model = model.to(device)
    model.eval()

    feats: List[np.ndarray] = []
    mapping: List[str] = []
    with torch.no_grad():
        for asin, images in item_images:
            batch = torch.stack([transform(img) for img in images]).to(device)
            pooled = model.global_pool(model.forward_features(batch))
            if pooled.dim() > 2:
                pooled = pooled.flatten(1)
            feats.append(pooled.mean(dim=0).cpu().numpy().astype(np.float32))
            mapping.append(asin)
    if not feats:
        return np.zeros((0, 0), np.float32), []
    return np.stack(feats), mapping


def extract_textual_features(
    item_texts: Dict[str, Sequence[str]],
    model=None,
    tokenizer=None,
    model_name: str = "bert-base-uncased",
    device: str = "cuda",
    batch_size: int = 16,
    max_length: int = TEXT_MAX_LENGTH,
) -> Tuple[np.ndarray, List[str]]:
    """Per-item textual features: the CLS hidden state of each non-empty
    review, in batches of ``batch_size`` reviews padded to the batch's
    longest and truncated to ``max_length`` tokens, mean over the item's
    reviews. A model or tokenizer left None is loaded from
    ``model_name``. Returns (features [K, D] float32, asins in dict
    order; items without a non-empty review are left out)."""
    model, tokenizer = load_text_model(model_name, model, tokenizer)
    model = model.to(device)
    model.eval()

    feats: List[np.ndarray] = []
    mapping: List[str] = []
    with torch.no_grad():
        for asin, texts in item_texts.items():
            texts = [t for t in texts if t]
            if not texts:
                continue
            cls_rows = []
            for i in range(0, len(texts), batch_size):
                enc = tokenizer(
                    list(texts[i: i + batch_size]),
                    padding=True,
                    truncation=True,
                    max_length=max_length,
                    return_tensors="pt",
                ).to(device)
                out = model(**enc)
                cls_rows.append(out.last_hidden_state[:, 0].cpu().numpy())
            feats.append(np.concatenate(cls_rows).mean(axis=0).astype(np.float32))
            mapping.append(asin)
    if not feats:
        return np.zeros((0, 0), np.float32), []
    return np.stack(feats), mapping


def save_feats_npz(path: str, feats: np.ndarray, asins: Sequence[str]) -> None:
    """Write extracted features as ``preprocess``'s drop-in file (keys
    ``feats`` [n, dim] and ``asins`` [n])."""
    np.savez_compressed(path, feats=feats, asins=np.asarray(list(asins), dtype=object))
