"""Checkpoint save/restore with best/last retention (counterpart of
``pmgt_tpu/train/checkpoints.py``, which uses orbax).

A checkpoint is a directory (``best/``, ``last/``, ``swa/``) holding one
file, ``state.pt``: a ``torch.save`` of a CPU copy of the payload (nested
dicts, lists and tuples of tensors and Python scalars). Restores use
``weights_only=True``. Saves are synchronous: the PMGT training state is
about 14 MB.

Crash safety: a save writes ``<path>.tmp_new`` first; finalize renames the
previous complete copy aside to ``<path>.old``, renames the new one in and
only then deletes the aside copy, so a kill at any instant leaves at least
one complete checkpoint on disk. ``checkpoint_exists`` promotes a stranded
aside copy back.

In a data-parallel group only rank 0 writes (saves, ``best.json`` and the
promotion); every rank reads, after a barrier (``train/engine.py``). The aside copy is deleted before the next rename only
when ``<path>`` itself is complete: after a finalize that failed between
its two renames, the aside copy is the only complete checkpoint and stays
until a new one is in place.
"""
from __future__ import annotations

import io
import json
import os
import shutil
from typing import Any, Optional, Sequence, Union

import torch

from pmgt_tpu_torch.core.mesh import current_mesh

CKPT_FILE = "state.pt"


def _to_cpu(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _finalize(tmp: str, final: str) -> None:
    old = final + ".old"
    if os.path.isdir(final):
        # `final` is complete, so an aside copy left by an earlier save
        # is stale; with `final` missing the aside copy must stay.
        shutil.rmtree(old, ignore_errors=True)
        os.replace(final, old)
    os.replace(tmp, final)
    shutil.rmtree(old, ignore_errors=True)


def checkpoint_exists(path: str) -> bool:
    """True if a finalized checkpoint directory exists at ``path``.

    Promotes a crash-stranded aside copy first: a kill between finalize's
    two renames leaves ``path`` missing with the previous complete
    checkpoint at ``path + ".old"``."""
    path = os.path.abspath(path)
    old = path + ".old"
    if not os.path.isdir(path) and os.path.isdir(old) and current_mesh().is_primary:
        os.replace(old, path)
    return os.path.isdir(path)


def save_checkpoint(path: Union[str, Sequence[str]], payload: Any) -> None:
    """Save ``payload`` at ``path``, or at each of a sequence of paths,
    atomically replacing any checkpoint there. The payload is moved to the
    CPU and serialized once, whatever the number of paths. Only rank 0
    of a group writes."""
    if not current_mesh().is_primary:
        return
    paths = [path] if isinstance(path, str) else list(path)
    buf = io.BytesIO()
    torch.save(_to_cpu(payload), buf)
    for p in paths:
        p = os.path.abspath(p)
        tmp = p + ".tmp_new"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        with open(os.path.join(tmp, CKPT_FILE), "wb") as f:
            f.write(buf.getbuffer())
        _finalize(tmp, p)


def restore_checkpoint(path: str) -> Any:
    """The payload saved at ``path``, on the CPU."""
    return torch.load(
        os.path.join(os.path.abspath(path), CKPT_FILE),
        map_location="cpu",
        weights_only=True,
    )


def write_best_info(ckpt_dir: str, monitor: str, value: float, epoch: int) -> None:
    if not current_mesh().is_primary:
        return
    with open(os.path.join(ckpt_dir, "best.json"), "w", encoding="utf-8") as f:
        json.dump(
            {"monitor": monitor, "value": float(value), "epoch": int(epoch)}, f
        )


def read_best_info(ckpt_dir: str) -> Optional[dict]:
    path = os.path.join(ckpt_dir, "best.json")
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        return json.load(f)
