"""Checkpoint save/load with real resume (port of
``aadg_tpu/utils/checkpoint.py:100-253``).

A checkpoint is a ``torch.save`` of a nested dict that holds only tensors,
numbers, strings and containers, so it loads with ``weights_only=True``.
Each file is written to ``<name>.tmp`` and renamed over the target, so a
crash mid-write never leaves a truncated checkpoint; ``latest.pt`` is a
symlink to the newest one and ``model_best.pt`` a copy of the best.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import re
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

# the run directory's time suffix (utils/logging.py: RUN_TIME_FORMAT)
_RUN_TIME_RE = r"_\d{4}-\d{2}-\d{2}-\d{2}-\d{2}-\d{2}$"


def save_checkpoint(state: Dict[str, Any], is_best: bool, output_dir: str,
                    filename: str = "checkpoint.pt",
                    update_latest: bool = True) -> str:
    """Write ``<output_dir>/<filename>``; re-point ``latest.pt`` at it and,
    on ``is_best``, copy it to ``model_best.pt``."""
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, filename)
    torch.save(state, path + ".tmp")
    os.replace(path + ".tmp", path)
    if update_latest:
        latest = os.path.join(output_dir, "latest.pt")
        tmp = latest + ".tmp"
        if os.path.islink(tmp) or os.path.exists(tmp):
            os.remove(tmp)
        os.symlink(os.path.basename(path), tmp)
        os.replace(tmp, latest)
    if is_best:
        best = os.path.join(output_dir, "model_best.pt")
        shutil.copyfile(path, best + ".tmp")
        os.replace(best + ".tmp", best)
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The dict written by :func:`save_checkpoint`, tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def latest_checkpoint(output_dir: str) -> Optional[str]:
    latest = os.path.join(output_dir, "latest.pt")
    if os.path.exists(latest):
        return os.path.realpath(latest)
    return None


def find_resume_checkpoint(output_dir: str) -> Optional[str]:
    """The checkpoint to auto-resume from: ``latest.pt`` of this run, else
    the most recently written ``latest.pt`` among sibling runs of the same
    config (``<stem>_<time>``; a restarted process gets a fresh run
    directory). Runs of other configs whose names extend the stem are not
    candidates."""
    ck = latest_checkpoint(output_dir)
    if ck:
        return ck
    d = os.path.normpath(output_dir)
    stem = re.sub(_RUN_TIME_RE, "", os.path.basename(d))
    candidates = []
    for sib in glob.glob(os.path.join(os.path.dirname(d), stem + "_*")):
        if os.path.normpath(sib) == d:
            continue
        if re.sub(_RUN_TIME_RE, "", os.path.basename(
                os.path.normpath(sib))) != stem:
            continue
        ck = latest_checkpoint(sib)
        if ck:
            candidates.append(ck)
    if not candidates:
        return None
    best = max(candidates, key=os.path.getmtime)
    logging.getLogger().warning(
        "auto-resume: no checkpoint in %s; resuming from sibling run %s",
        output_dir, os.path.dirname(best))
    return best


def save_json(obj: Any, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(json.dumps(obj, default=_jsonify))


def _jsonify(o):
    if hasattr(o, "item"):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not jsonifiable: {type(o)}")


def save_array(arr, path: str) -> None:
    """Save a trajectory array (``*_trajectory.npy``)."""
    np.save(path, np.asarray(arr))
