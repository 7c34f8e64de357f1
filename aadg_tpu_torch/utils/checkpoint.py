"""Checkpoint save/load with real resume (port of
``aadg_tpu/utils/checkpoint.py:68-253``).

A checkpoint is a ``torch.save`` of a nested dict that holds only tensors,
numbers, strings and containers, so it loads with ``weights_only=True``.
Each file is written to ``<name>.tmp`` and renamed over the target, so a
crash mid-write never leaves a truncated checkpoint; ``latest.pt`` is a
symlink to the newest one and ``model_best.pt`` a copy of the best.

``save_checkpoint(..., background=True)`` copies the state to the host in
the caller (later steps update the modules in place, so the copy must be
taken before they run) and writes it on a daemon thread, one in flight per
output directory: a second save to the directory joins the first. A
writer's exception is re-raised when it is joined, by the next save, by
``wait_pending_checkpoints`` or by any load (``load_checkpoint``,
``latest_checkpoint``), which wait for every pending write first.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import re
import shutil
import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

# the run directory's time suffix (utils/logging.py: RUN_TIME_FORMAT)
_RUN_TIME_RE = r"_\d{4}-\d{2}-\d{2}-\d{2}-\d{2}-\d{2}$"


class _SaveThread(threading.Thread):
    """Writer that keeps its exception and its own seconds for the join."""

    def __init__(self, target: Callable[[], None],
                 on_joined: Optional[Callable[[float], None]]):
        super().__init__(daemon=True)
        self._target_fn = target
        self._on_joined = on_joined
        self.error: Optional[BaseException] = None
        self.seconds = 0.0

    def run(self):
        t0 = time.perf_counter()
        try:
            self._target_fn()
        except BaseException as e:  # re-raised at join_or_raise
            self.error = e
        finally:
            self.seconds = time.perf_counter() - t0

    def join_or_raise(self):
        self.join()
        if self.error is not None:
            raise self.error
        if self._on_joined is not None:
            self._on_joined(self.seconds)


_PENDING_SAVE: Dict[str, _SaveThread] = {}


def wait_pending_checkpoints() -> None:
    """Join every background write in flight and re-raise the first
    writer's exception (call before the final saves and before a load)."""
    threads = list(_PENDING_SAVE.values())
    _PENDING_SAVE.clear()
    for t in threads:
        t.join_or_raise()


def to_host(obj):
    """``obj`` with every tensor copied to the host (a copy even of a host
    tensor, which the caller may go on to update in place). A state_dict
    keeps its type and its ``_metadata``."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        out = type(obj)((k, to_host(v)) for k, v in obj.items())
        if hasattr(obj, "_metadata"):
            out._metadata = obj._metadata
        return out
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj


def save_checkpoint(state: Dict[str, Any], is_best: bool, output_dir: str,
                    filename: str = "checkpoint.pt",
                    update_latest: bool = True, background: bool = False,
                    on_joined: Optional[Callable[[float], None]] = None
                    ) -> str:
    """Write ``<output_dir>/<filename>``; re-point ``latest.pt`` at it and,
    on ``is_best``, copy it to ``model_best.pt``. With ``background`` the
    write runs on a thread after the host copy, and ``on_joined`` gets the
    thread's own seconds when the write is joined."""
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, filename)
    host_state = to_host(state) if background else state

    def write():
        torch.save(host_state, path + ".tmp")
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

    if not background:
        write()
        return path
    prev = _PENDING_SAVE.pop(output_dir, None)
    if prev is not None:
        prev.join_or_raise()
    t = _SaveThread(write, on_joined)
    t.start()
    _PENDING_SAVE[output_dir] = t
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The dict written by :func:`save_checkpoint`, tensors on the CPU,
    once every pending write has ended."""
    wait_pending_checkpoints()
    return torch.load(path, map_location="cpu", weights_only=True)


def latest_checkpoint(output_dir: str) -> Optional[str]:
    wait_pending_checkpoints()
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
