"""The port's entry point end to end on the CPU: the flagship config cut to
synthetic_optic at crop 64, B=2, M=2 (f32, as the CPU parity tests run)
runs one warmup and one search epoch with finite losses and rewards and
writes the trajectories."""

import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from aadg_tpu_torch import run as trun
from torch_port_helpers import few_torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
OVERRIDES = ["DATASET.NAME", "synthetic_optic", "TPU.CROP_SIZE", "64",
             "TRAIN.BATCH_SIZE", "2", "CONTROLLER.M", "2",
             "TPU.COMPUTE_DTYPE", "float32"]


def test_smoke_search_in_process(tmp_path):
    summary = trun.main(["--cfg", str(ROOT / "experiments/optic_sinkhorn/"
                                      "diversity.yaml"),
                         "--device", "cpu", "--smoke_test",
                         "--output_dir", str(tmp_path), *OVERRIDES])
    kinds = [e["kind"] for e in summary["epochs"]]
    assert kinds == ["warmup", "search"]
    for e in summary["epochs"]:
        assert all(math.isfinite(v) for v in e["metrics"].values()), e
    search = summary["epochs"][1]
    assert len(search["rewards"]) == 2
    assert all(math.isfinite(r) for r in search["rewards"])
    assert all(math.isfinite(v) for v in search["controller"].values())
    assert summary["images_per_search_step"] == 2 * 3 * 2
    out = Path(summary["out_dir"])
    assert np.load(out / "op_probs_trajectory.npy").shape == (1, 10)
    assert np.load(out / "mag_probs_trajectory.npy").shape == (1, 10)
    assert "Train Epoch 1" in (out / "train.log").read_text()


def test_module_entry_point_runs(tmp_path):
    """``python -m aadg_tpu_torch.run`` as a user calls it."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "aadg_tpu_torch.run", "--cfg",
         "experiments/optic_sinkhorn/diversity.yaml", "--device", "cpu",
         "--smoke_test", "--output_dir", str(tmp_path), *OVERRIDES],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "controller loss" in proc.stderr
