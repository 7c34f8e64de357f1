"""The port's entry point end to end on the CPU: the flagship config cut to
synthetic_optic at crop 64, B=2, M=2 (f32, as the CPU parity tests run).

- ``--mode search`` runs one warmup and one search epoch with finite
  losses and rewards, validates after each and writes the checkpoints,
  trajectories and final artifacts;
- ``--mode train TPU.AUTOAUGMENT True TEST.MODEL_DIR <search dir>`` and
  ``--mode test --output_type seg|image`` run on what the search left;
- test mode's per-image F1 agrees with ``aadg_tpu``'s ``run_test`` from
  the same weights within 1e-3, and its PNG maps with the JAX model's
  thresholded maps on at least 99.9% of the pixels;
- ``TPU.PROFILE True`` writes one ``torch.profiler`` trace of the first
  epoch (the warmup's steps, none of the search epoch's) to
  ``<run dir>/profile`` and logs where;
- ``TPU.PRETRAINED`` naming a seeded torchvision MobileNetV2 converted by
  ``python -m aadg_tpu_torch.convert_weights`` (auto-grafted, or as
  ``file::encoder``): search and train start from the file's encoder
  weights exactly, log where they went, and run finite.
"""

import csv
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from aadg_tpu import utils as jutils
from aadg_tpu.config import load_config as jax_load_config
from aadg_tpu.engine import test as jtest
from aadg_tpu_torch import convert_weights
from aadg_tpu_torch import run as trun
from aadg_tpu_torch.engine import search as tsearch
from aadg_tpu_torch.engine import state as tstate
from aadg_tpu_torch.engine import train as ttrain
from aadg_tpu_torch.utils import checkpoint as tck
from aadg_tpu_torch.utils.png import encode_png
from aadg_tpu_torch.weights import from_flax
from test_torch_parity import _torch_mobilenet_v2
from torch_port_helpers import few_torch_threads  # noqa: F401
from torch_port_helpers import (CFG, OPTS, _np, sharpen_seg_head,
                                step_pair)

ROOT = Path(__file__).resolve().parent.parent
OVERRIDES = ["DATASET.NAME", "synthetic_optic", "TPU.CROP_SIZE", "64",
             "TRAIN.BATCH_SIZE", "2", "CONTROLLER.M", "2",
             "TPU.COMPUTE_DTYPE", "float32"]


def _main(tmp_path, *args):
    return trun.main(["--cfg", str(ROOT / CFG), "--device", "cpu",
                      "--output_dir", str(tmp_path / "output"), *args,
                      *OVERRIDES, "LOG_DIR", str(tmp_path / "log")])


def _check_final_result(path: Path, with_hd: bool):
    res = json.loads(path.read_text())
    keys = ["avg_dsc", "cup_dsc", "disc_dsc"] + (
        ["avg_hd", "cup_hd", "disc_hd"] if with_hd else [])
    assert set(res) == {"epoch", *keys}
    for k in keys:
        assert math.isfinite(res[k]), (k, res)
        assert 0.0 <= res[k] <= (100.0 if k.endswith("hd") else 1.0), k
    return res


def test_smoke_search_in_process(tmp_path):
    summary = _main(tmp_path, "--smoke_test")
    kinds = [e["kind"] for e in summary["epochs"]]
    assert kinds == ["warmup", "search"]
    for e in summary["epochs"]:
        assert all(math.isfinite(v) for v in e["metrics"].values()), e
        assert set(e["valid"]) == {"cup_dsc", "disc_dsc", "cup_hd",
                                   "disc_hd"}
        assert all(math.isfinite(v) for v in e["valid"].values()), e
    search = summary["epochs"][1]
    assert len(search["rewards"]) == 2
    assert all(math.isfinite(r) for r in search["rewards"])
    assert all(math.isfinite(v) for v in search["controller"].values())
    assert summary["images_per_search_step"] == 2 * 3 * 2
    out = Path(summary["out_dir"])
    assert np.load(out / "op_probs_trajectory.npy").shape == (1, 10)
    assert np.load(out / "mag_probs_trajectory.npy").shape == (1, 10)
    log = (out / "train.log").read_text()
    assert "Train Epoch 1" in log and "Test Epoch 1 dsc@cup:" in log
    assert "=> best:" in log
    # checkpoint_<epoch> on search epochs only (CHECKPOINT_FREQ 1)
    assert os.readlink(out / "latest.pt") == "checkpoint_1.pt"
    assert not (out / "checkpoint_0.pt").exists()
    ckpt = tck.load_checkpoint(str(out / "checkpoint_1.pt"))
    assert set(ckpt) == {"sd", "cs", "epoch", "best_dsc", "best_metric",
                         "generator"}
    assert ckpt["epoch"] == 2
    assert "controller" in tck.load_checkpoint(
        str(out / "final_controller_state.pt"))
    assert "model" in tck.load_checkpoint(str(out / "final_model_state.pt"))
    res = _check_final_result(out / "final_result.json", with_hd=True)
    assert res == summary["best_metric"]
    scalars = (tmp_path / "log").rglob("scalars.jsonl")
    tags = {json.loads(ln)["tag"] for f in scalars
            for ln in f.read_text().splitlines()}
    assert {"train_seg_loss", "valid_cup_dsc", "valid_disc_hd",
            "controller_loss"} <= tags


def test_search_train_test_chain_in_process(tmp_path):
    search = _main(tmp_path, "--smoke_test")
    train = _main(tmp_path, "--mode", "train", "TPU.AUTOAUGMENT", "True",
                  "TEST.MODEL_DIR", search["out_dir"], "TRAIN.END_EPOCH",
                  "2", "TPU.STEPS_PER_EPOCH", "2")
    assert [e["epoch"] for e in train["epochs"]] == [0, 1]
    assert len(train["train_step_seconds"]) == 4
    assert train["images_per_train_step"] == 2 * 3
    for e in train["epochs"]:
        assert set(e["metrics"]) == {"seg_loss", "cup_dsc", "disc_dsc"}
        assert all(math.isfinite(v) for v in e["metrics"].values()), e
        assert all(math.isfinite(v) for v in e["valid"].values()), e
    out = Path(train["out_dir"])
    assert out != Path(search["out_dir"])
    for name in ("checkpoint_0.pt", "checkpoint_1.pt", "final_state.pt"):
        assert (out / name).exists(), name
    log = (out / "train.log").read_text()
    assert "autoaugment: loaded controller" in log
    _check_final_result(out / "final_result.json", with_hd=False)

    seg_dir = tmp_path / "vis_seg"
    table = _main(tmp_path, "--mode", "test", "--output_type", "seg",
                  "--vis_dir", str(seg_dir), "TEST.MODEL_DIR",
                  train["out_dir"])
    assert len(table["name"]) == 4
    for name in table["name"]:
        seg = imageio.imread(seg_dir / name)
        assert seg.shape == (64, 64) and seg.dtype == np.uint8
        assert set(np.unique(seg)) <= {0, 127, 255}
    with open(seg_dir / "test_result.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert [r["name"] for r in rows] == table["name"]
    for r in rows:
        for k in ("f1_score_avg", "f1_score_disc", "f1_score_cup"):
            assert 0.0 <= float(r[k]) <= 1.0

    img_dir = tmp_path / "vis_img"
    res = _main(tmp_path, "--mode", "test", "--output_type", "image",
                "--vis_dir", str(img_dir), "TEST.MODEL_DIR",
                search["out_dir"])
    assert res == {"n_images": 32}
    files = sorted(os.listdir(img_dir))
    assert files == sorted(f"sample{j}_{k}.png" for j in range(8)
                           for k in range(4))
    assert imageio.imread(img_dir / files[0]).shape == (64, 64, 3)


def _composite(hard: np.ndarray) -> np.ndarray:
    """The test mode's map of one (H, W, 2) hard mask: disc 127, cup 255."""
    seg_map = np.where(hard[..., 1] == 1, 0.5, 0.0)
    seg_map = np.where(hard[..., 0] == 1, 1.0, seg_map)
    return (seg_map * 255).astype(np.uint8)


def test_test_mode_matches_jax_run_test(tmp_path, monkeypatch):
    _, sd, _, _ = step_pair()
    sd = sharpen_seg_head(sd)
    jdir, tdir = tmp_path / "jax_run", tmp_path / "port_run"
    jutils.save_checkpoint({"params": sd.seg_params,
                            "batch_stats": sd.seg_stats}, False, str(jdir),
                           "final_state.msgpack", update_latest=False)
    tck.save_checkpoint({"model": from_flax({
        "params": _np(sd.seg_params), "batch_stats": _np(sd.seg_stats)})},
        False, str(tdir), "final_state.pt", update_latest=False)
    # run_test's template state: the checkpoint replaces its weights, and
    # JAX's eager init of a fresh one takes half a minute on the CPU
    monkeypatch.setattr(jtest, "init_state", lambda ent, key: (sd, None))
    # keep the JAX model's probabilities: its maps are written as JPG
    probs, make_fwd = [], jtest.make_eval_forward

    def recording_forward(ent):
        fwd = make_fwd(ent)

        def call(*args):
            out = fwd(*args)
            probs.append(np.asarray(out))
            return out
        return call
    monkeypatch.setattr(jtest, "make_eval_forward", recording_forward)
    jcfg = jax_load_config(CFG, OPTS + ["TEST.MODEL_DIR", str(jdir)])
    want = jtest.run_test(jcfg, CFG, vis_dir=str(tmp_path / "jax_vis"),
                          output_type="seg")
    vis = tmp_path / "port_vis"
    got = trun.main(["--cfg", CFG, "--device", "cpu", "--mode", "test",
                     "--output_type", "seg", "--vis_dir", str(vis), *OPTS,
                     "TEST.MODEL_DIR", str(tdir)])
    assert list(got) == list(want) and got["name"] == want["name"]
    for k in ("f1_score_avg", "f1_score_disc", "f1_score_cup"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-3,
                                   err_msg=k)
    assert max(want["f1_score_disc"]) > 0.05  # the maps are not empty
    for name, p in zip(want["name"], np.concatenate(probs)):
        mine = imageio.imread(vis / (name[:-3] + "png"))
        ref = _composite((p > 0.75).astype(np.float32))
        assert float(np.mean(mine == ref)) >= 0.999, name


@pytest.mark.parametrize("shape", [(5, 7), (4, 9, 3), (1, 1)])
def test_png_writer_round_trips(shape):
    arr = np.random.default_rng(sum(shape)).integers(
        0, 256, shape).astype(np.uint8)
    np.testing.assert_array_equal(imageio.imread(encode_png(arr)), arr)


def test_module_entry_point_runs(tmp_path):
    """``python -m aadg_tpu_torch.run`` as a user calls it."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "aadg_tpu_torch.run", "--cfg",
         "experiments/optic_sinkhorn/diversity.yaml", "--device", "cpu",
         "--smoke_test", "--output_dir", str(tmp_path), *OVERRIDES,
         "LOG_DIR", str(tmp_path / "log")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "controller loss" in proc.stderr
    assert "Test Epoch 1" in proc.stderr


def test_profile_traces_the_first_epoch(tmp_path):
    summary = _main(tmp_path, "--smoke_test", "TPU.PROFILE", "True")
    out = Path(summary["out_dir"])
    files = list((out / "profile").iterdir())
    assert [f.name for f in files] == ["trace.json"]
    assert files[0].stat().st_size > 0
    names = {e.get("name") for e in json.loads(files[0].read_text())[
        "traceEvents"]}
    assert "pretrain/forward_backward" in names      # epoch 0, warmup
    assert "search/augment" not in names             # epoch 1, search
    log = (out / "train.log").read_text()
    assert log.count("profiler trace written to") == 1
    assert f"profiler trace written to {out / 'profile'}" in log


@pytest.mark.parametrize("mode,graft", [("search", ""), ("train", ""),
                                        ("search", "::encoder")])
def test_pretrained_weights_start_the_run(tmp_path, monkeypatch, mode,
                                          graft):
    torch.manual_seed(0)
    src, dst = tmp_path / "mnv2.pth", tmp_path / "mnv2.pt"
    torch.save({f"features.{k}": v
                for k, v in _torch_mobilenet_v2().state_dict().items()}, src)
    assert convert_weights.main(["--arch", "mobilenet_v2", str(src),
                                 str(dst)]) == 0
    engine = {"search": tsearch, "train": ttrain}[mode]
    at_start = []

    def spy(ent, seed, pretrained="", logger=None):
        sd, cs = tstate.init_state(ent, seed, pretrained, logger)
        at_start.append({k: v.clone()
                         for k, v in sd.model.encoder.state_dict().items()})
        return sd, cs
    monkeypatch.setattr(engine, "init_state", spy)
    summary = _main(tmp_path, "--mode", mode, "--smoke_test",
                    "TPU.PRETRAINED", f"{dst}{graft}")
    loaded = torch.load(dst, weights_only=True)
    assert len(at_start) == 1 and sorted(at_start[0]) == sorted(loaded)
    for k, v in loaded.items():
        assert torch.equal(at_start[0][k], v), k
    for e in summary["epochs"]:
        assert all(math.isfinite(v) for v in e["metrics"].values()), e
    log = (Path(summary["out_dir"]) / "train.log").read_text()
    assert f"loaded pretrained weights {dst} at encoder" in log
