"""SegFormer through the port's entry point on the CPU:
``experiments/zoo/segformer_b4_optic.yaml`` (stochastic depth 0.1,
``TPU.REMAT`` on) cut to MiT-b0 on synthetic_optic at crop 64, B=1, M=2.

- ``--mode search --smoke_test`` runs one warmup and one search epoch
  with finite losses, rewards and validation, and writes its checkpoint
  and final artifacts; ``--mode train TPU.AUTOAUGMENT True`` runs on the
  searched controller, and ``--mode test`` writes the maps and table
  (``seg``) and the augmented images (``image``);
- a search of a warmup and two search epochs equals, bit for bit, a run
  of the warmup and one search epoch and a second run that auto-resumes
  from its checkpoint: the stochastic-depth and dropout
  masks come from the run's generator, whose state the checkpoint keeps.
"""

import math
import os
from pathlib import Path

import torch

from aadg_tpu_torch import run as trun
from aadg_tpu_torch.utils import checkpoint as ck
from torch_port_helpers import few_torch_threads  # noqa: F401
from torch_port_helpers import SEG_CFG

ROOT = Path(__file__).resolve().parent.parent
OPTS = ["DATASET.NAME", "synthetic_optic", "TPU.CROP_SIZE", "64",
        "TRAIN.BATCH_SIZE", "1", "CONTROLLER.M", "2",
        "MODEL.BACKBONE", "mit_b0"]


def _main(out, *args):
    return trun.main(["--cfg", str(ROOT / SEG_CFG), "--device", "cpu",
                      "--output_dir", str(out), *args, *OPTS,
                      "LOG_DIR", str(out / "log")])


def _finite(summary):
    for e in summary["epochs"]:
        vals = (list(e["metrics"].values()) + list(e["valid"].values())
                + e.get("rewards", []))
        assert all(math.isfinite(v) for v in vals), e


def test_search_train_test_chain(tmp_path):
    search = _main(tmp_path, "--smoke_test")
    assert [e["kind"] for e in search["epochs"]] == ["warmup", "search"]
    _finite(search)
    assert len(search["epochs"][1]["rewards"]) == 2
    assert search["images_per_search_step"] == 1 * 3 * 2
    out = Path(search["out_dir"])
    model = ck.load_checkpoint(str(out / "final_model_state.pt"))["model"]
    assert "backbone.block4_1.ffn.dwconv.weight" in model
    assert model["head.linear_c4.weight"].shape == (256, 256)

    train = _main(tmp_path, "--mode", "train", "TPU.AUTOAUGMENT", "True",
                  "TEST.MODEL_DIR", search["out_dir"], "TRAIN.END_EPOCH", "1",
                  "TPU.STEPS_PER_EPOCH", "2")
    assert len(train["train_step_seconds"]) == 2
    _finite(train)
    assert "autoaugment: loaded controller" in (
        Path(train["out_dir"]) / "train.log").read_text()

    seg_dir = tmp_path / "vis_seg"
    table = _main(tmp_path, "--mode", "test", "--output_type", "seg",
                  "--vis_dir", str(seg_dir), "TEST.MODEL_DIR",
                  train["out_dir"])
    assert len(table["name"]) == 4
    assert sorted(p.name for p in seg_dir.glob("*.png")) == sorted(
        table["name"])
    assert all(0.0 <= v <= 1.0 for v in table["f1_score_avg"])
    img_dir = tmp_path / "vis_img"
    res = _main(tmp_path, "--mode", "test", "--output_type", "image",
                "--vis_dir", str(img_dir), "TEST.MODEL_DIR",
                search["out_dir"])
    assert res == {"n_images": 32}


def test_resumed_search_is_bit_identical(tmp_path):
    steps = ["TPU.STEPS_PER_EPOCH", "1", "TRAIN.WARMUP_EPOCH", "1"]
    whole = _main(tmp_path / "whole", *steps, "TRAIN.END_EPOCH", "3")
    _main(tmp_path / "split", *steps, "TRAIN.END_EPOCH", "2")
    resumed = _main(tmp_path / "split", *steps, "TRAIN.END_EPOCH", "3",
                    "TPU.AUTO_RESUME", "True")
    assert [e["epoch"] for e in resumed["epochs"]] == [2]
    a, b = whole["epochs"][2], resumed["epochs"][0]
    for k in ("rewards", "raw_rewards", "controller", "metrics", "valid"):
        assert a[k] == b[k], k
    for name in ("final_model_state.pt", "final_controller_state.pt"):
        want = ck.load_checkpoint(os.path.join(whole["out_dir"], name))
        got = ck.load_checkpoint(os.path.join(resumed["out_dir"], name))
        for part in want:
            assert want[part].keys() == got[part].keys()
            for k in want[part]:
                assert torch.equal(got[part][k], want[part][k]), (name, k)
