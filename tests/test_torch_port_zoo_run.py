"""Zoo configs through the port's entry point on the CPU
(``python -m aadg_tpu_torch.run --device cpu --smoke_test``), at crop 64,
B=1 per domain, M=2:

- ``experiments/zoo/lraspp_mnv3_optic.yaml`` (LR-ASPP / MobileNetV3-large)
  on synthetic_optic;
- ``experiments/zoo/ocrnet_hr18_rvs.yaml`` (OCRNet / HRNet-W18) on
  synthetic_rvs from 128 x 128 pools;
- ``experiments/zoo/pspnet_r50_optic.yaml`` with ``MODEL.NAME pointrend``
  (its validation and test maps run the subdivision refine) and with
  ``MODEL.NAME emanet`` (the EMA bases are saved in the checkpoint), each
  over ``MODEL.BACKBONE mobilenet_v3_small`` to keep the CPU run short,
  on synthetic_optic.

Each runs search (one warmup and one search epoch of two steps), train
with ``TPU.AUTOAUGMENT`` on the searched controller, and test (``seg``
from the train run, ``image`` from the search run): every loss, reward and
validation number finite, ``final_result.json`` with its task's keys in
range, the model checkpoint holding the zoo's modules, and the test
outputs written. The run writes its checkpoints on the background thread:
the epoch records carry the writer's own seconds.
"""

import json
import math
from pathlib import Path

import pytest

from aadg_tpu_torch import run as trun
from aadg_tpu_torch.utils import checkpoint as ck
from torch_port_helpers import few_torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = {
    # name: (config, overrides, final_result keys, a key of the model)
    "lraspp": ("experiments/zoo/lraspp_mnv3_optic.yaml",
               ["DATASET.NAME", "synthetic_optic"],
               ["avg_dsc", "cup_dsc", "disc_dsc"],
               "decode_head.image_pool.conv.weight"),
    "ocrnet": ("experiments/zoo/ocrnet_hr18_rvs.yaml",
               ["DATASET.NAME", "synthetic_rvs", "TPU.SYNTHETIC_SIZE", "128"],
               ["dsc", "acc", "aucroc", "sp", "se"],
               "cascade_heads_0.object_attention.key_project_1.conv.weight"),
    "pointrend": ("experiments/zoo/pspnet_r50_optic.yaml",
                  ["DATASET.NAME", "synthetic_optic", "MODEL.NAME",
                   "pointrend", "MODEL.BACKBONE", "mobilenet_v3_small"],
                  ["avg_dsc", "cup_dsc", "disc_dsc"],
                  "point_head.fc_seg.weight"),
    "emanet": ("experiments/zoo/pspnet_r50_optic.yaml",
               ["DATASET.NAME", "synthetic_optic", "MODEL.NAME", "emanet",
                "MODEL.BACKBONE", "mobilenet_v3_small"],
               ["avg_dsc", "cup_dsc", "disc_dsc"], "decode_head.bases"),
}


def _finite(summary):
    for e in summary["epochs"]:
        vals = (list(e["metrics"].values()) + list(e["valid"].values())
                + e.get("rewards", []))
        assert all(math.isfinite(v) for v in vals), e


def _result(run_dir, keys):
    res = json.loads((Path(run_dir) / "final_result.json").read_text())
    for k in keys:
        top = 100.0 if k.endswith("hd") else 1.0
        assert math.isfinite(res[k]) and 0.0 <= res[k] <= top, (k, res)
    return res


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_zoo_search_train_test_chain(tmp_path, name):
    cfg, data, keys, model_key = CONFIGS[name]

    def main(*args):
        return trun.main(["--cfg", str(ROOT / cfg), "--device", "cpu",
                          "--output_dir", str(tmp_path), *args, *data,
                          "TPU.CROP_SIZE", "64", "TRAIN.BATCH_SIZE", "1",
                          "CONTROLLER.M", "2", "LOG_DIR",
                          str(tmp_path / "log")])

    search = main("--smoke_test")
    assert [e["kind"] for e in search["epochs"]] == ["warmup", "search"]
    _finite(search)
    assert len(search["epochs"][1]["rewards"]) == 2
    assert search["epochs"][1]["checkpoint_write_seconds"] > 0
    _result(search["out_dir"], keys + (["avg_hd"] if "avg_dsc" in keys
                                       else []))
    model = ck.load_checkpoint(str(Path(search["out_dir"])
                                   / "final_model_state.pt"))["model"]
    assert model_key in model

    train = main("--mode", "train", "TPU.AUTOAUGMENT", "True",
                 "TEST.MODEL_DIR", search["out_dir"], "TRAIN.END_EPOCH", "1",
                 "TPU.STEPS_PER_EPOCH", "2")
    assert len(train["train_step_seconds"]) == 2
    _finite(train)
    _result(train["out_dir"], keys)
    assert "autoaugment: loaded controller" in (
        Path(train["out_dir"]) / "train.log").read_text()

    seg_dir = tmp_path / "vis_seg"
    table = main("--mode", "test", "--output_type", "seg", "--vis_dir",
                 str(seg_dir), "TEST.MODEL_DIR", train["out_dir"])
    assert sorted(p.name for p in seg_dir.glob("*.png")) == sorted(
        table["name"])
    assert all(0.0 <= v <= 1.0 for k, vs in table.items() if k != "name"
               for v in vs)
    res = main("--mode", "test", "--output_type", "image", "--vis_dir",
               str(tmp_path / "vis_img"), "TEST.MODEL_DIR", search["out_dir"])
    assert res == {"n_images": 32}
