"""Checkpoints with full resume (port of svgpvae_tpu/utils/checkpoint.py,
which keeps the whole TrainState pytree with orbax).

One `torch.save` file per step, <ckpt_dir>/<step>.pt, holding whatever
dict the driver hands over: the TrainState's state_dict (parameters,
optimizer moments, GECO state, step), the state of the driver's training
noise generator and, on SPRITES, the pretraining head.  The file is
written under a temporary name and renamed into place, so a process
killed mid-write leaves the last complete checkpoint as the latest.
Files are read with weights_only=True (tensors and plain containers).
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import torch

_NAME = re.compile(r"^(\d+)\.pt$")


def _steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match,
                                               os.listdir(ckpt_dir)) if m)


def save_checkpoint(ckpt_dir: str, state: dict, step: int,
                    max_to_keep: int = 3) -> str:
    """Write `state` as <ckpt_dir>/<step>.pt (atomically) and delete all
    but the newest `max_to_keep` checkpoints.  Returns the file's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{step}.pt")
    tmp = os.path.join(ckpt_dir, f".{step}.pt.tmp")
    try:
        torch.save(state, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    for old in _steps(ckpt_dir)[:-max_to_keep]:
        os.remove(os.path.join(ckpt_dir, f"{old}.pt"))
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest checkpoint's step under ckpt_dir, or None."""
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None) -> dict:
    """The dict saved at `step` (default: the latest), tensors on the
    CPU."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    return torch.load(os.path.join(ckpt_dir, f"{step}.pt"),
                      map_location="cpu", weights_only=True)
