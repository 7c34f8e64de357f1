"""Run directory, file logger and scalar log (port of
``aadg_tpu/utils/logging.py:37-103``).

``create_logger`` makes ``<OUTPUT_DIR>/<dataset>/<cfg>_<time>/`` with a
``<phase>.log`` file logger that also prints, and a scalar-log directory
``<LOG_DIR>/<dataset>/<model>/<cfg>_<time>_<time>``. The run-directory
time has seconds (``%Y-%m-%d-%H-%M-%S``), so two runs a minute apart get
two directories. ``ScalarWriter`` appends one JSON line per scalar to
``scalars.jsonl``; no TensorBoard writer is needed.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from pathlib import Path

RUN_TIME_FORMAT = "%Y-%m-%d-%H-%M-%S"


def create_logger(cfg, cfg_path: str, phase: str = "train"):
    """Returns (logger, run directory, scalar-log directory)."""
    stamp = time.strftime(RUN_TIME_FORMAT)
    name = f"{Path(cfg_path).stem}_{stamp}"
    out_dir = Path(cfg.OUTPUT_DIR) / cfg.DATASET.NAME / name
    out_dir.mkdir(parents=True, exist_ok=True)
    logger = logging.getLogger(f"aadg_tpu_torch.{name}.{phase}.{os.getpid()}")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    if not logger.handlers:
        fh = logging.FileHandler(out_dir / f"{phase}.log")
        fh.setFormatter(logging.Formatter("%(asctime)-15s %(message)s"))
        logger.addHandler(fh)
        logger.addHandler(logging.StreamHandler())
    tb_dir = (Path(cfg.LOG_DIR) / cfg.DATASET.NAME / cfg.MODEL.NAME
              / f"{name}_{stamp}")
    tb_dir.mkdir(parents=True, exist_ok=True)
    return logger, str(out_dir), str(tb_dir)


class ScalarWriter:
    """Appends ``{"tag", "value", "step"}`` lines to ``scalars.jsonl``."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value, step: int) -> None:
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step)}) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()


@contextlib.contextmanager
def run_logging(cfg, cfg_path: str, phase: str = "train"):
    """``create_logger`` plus a ``ScalarWriter``, both closed on exit.
    Yields (logger, run directory, writer)."""
    logger, out_dir, tb_dir = create_logger(cfg, cfg_path, phase)
    writer = ScalarWriter(tb_dir)
    try:
        yield logger, out_dir, writer
    finally:
        writer.close()
        for handler in list(logger.handlers):
            handler.close()
            logger.removeHandler(handler)
