"""Test mode (port of ``aadg_tpu/engine/test.py``).

- ``output_type='seg'``: load the trained model and write the thresholded
  map of every test image and a per-image F1 table ``test_result.csv``.
  Optic: threshold 0.75, the cup/disc map (disc 127, cup 255, as
  ``(map * 255).astype(uint8)`` of a 0.5/1.0 map), columns ``name,
  f1_score_avg, f1_score_disc, f1_score_cup``. RVS: threshold 0.5, the
  binary vessel map (0/255), columns ``name, f1_score``.
- ``output_type='image'``: load the trained controller, sample 4
  policies, apply them on the device to 8 training images and write the
  32 augmented images.

Images are lossless PNG written with the standard library
(``utils/png.py``) under the JAX package's file stems; the JAX package
writes JPG. The table is written with the ``csv`` module.
"""

from __future__ import annotations

import csv
import os
from pathlib import Path

import numpy as np
import torch

from ..data.datasets import build_dataset, load_test_arrays, load_train_arrays
from ..data.stores import make_test_store
from ..data.transforms import optic_mask_to_multilabel, vessel_mask_to_binary
from ..metrics import samplewise_f1
from ..models.controller import policies_to_tensor
from ..ops.augment import draw_policy
from ..utils.checkpoint import load_checkpoint
from ..utils.png import write_png
from .evaluate import eval_forward
from .search import set_precision_flags
from .state import build_entities, init_state

N_VIS_POLICIES = 4
N_VIS_IMAGES = 8


def load_model_state(model: torch.nn.Module, model_dir: str,
                     logger=print) -> str:
    """Load the first of model_best -> final_model_state -> final_state
    found in ``model_dir`` into ``model``; returns its path."""
    for name in ("model_best.pt", "final_model_state.pt", "final_state.pt"):
        path = os.path.join(model_dir, name)
        if os.path.exists(path):
            state = load_checkpoint(path)
            model.load_state_dict(state["sd"]["model"] if "sd" in state
                                  else state["model"])
            logger(f"Successfully loaded: {path}")
            return path
    raise FileNotFoundError(f"no model checkpoint under {model_dir}")


def run_test(cfg, cfg_path: str, vis_dir: str = "vis",
             output_type: str = "seg", seed: int = 1023, device="cuda"):
    device = torch.device(device)
    set_precision_flags()
    out_dir = Path(vis_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    ent = build_entities(cfg, "train", steps_per_epoch=1, device=device)
    sd, cs = init_state(ent, int(cfg.SEED))
    if cfg.TEST.MODEL_DIR:
        load_model_state(sd.model, cfg.TEST.MODEL_DIR)
    if output_type == "seg":
        return _segment(cfg, ent, sd.model, out_dir)
    return _augment(cfg, ent, cs.controller, out_dir, seed)


def _f1(hard: torch.Tensor, y: torch.Tensor, c: int) -> float:
    """Dice of channel ``c`` of one (H, W, C) hard mask."""
    return float(samplewise_f1(hard[None, ..., c], y[None, ..., c])[1])


def _segment(cfg, ent, model, out_dir: Path):
    store = make_test_store(*load_test_arrays(build_dataset(cfg, "test")),
                            batch_size=int(cfg.TEST.BATCH_SIZE),
                            device=ent.device)
    optic = ent.dataset_name == "optic"
    threshold = 0.75 if optic else 0.5
    to_label = optic_mask_to_multilabel if optic else vessel_mask_to_binary
    output = ({"name": [], "f1_score_avg": [], "f1_score_disc": [],
               "f1_score_cup": []} if optic
              else {"name": [], "f1_score": []})
    bs = int(cfg.TEST.BATCH_SIZE)
    n = store.n_real
    for lo in range(0, n, bs):
        hi = min(lo + bs, n)
        soft = eval_forward(ent, model, store.images[lo:lo + bs])[:hi - lo]
        hard = (soft > threshold).float()
        y = to_label(store.labels[lo:hi].float())
        for j in range(hi - lo):
            name = store.names[lo + j]
            h_np = hard[j].cpu().numpy()
            if optic:
                cup, disc = _f1(hard[j], y[j], 0), _f1(hard[j], y[j], 1)
                # composite map: disc 0.5, cup 1.0
                seg_map = np.where(h_np[..., 1] == 1, 0.5, 0.0)
                seg_map = np.where(h_np[..., 0] == 1, 1.0, seg_map)
                output["f1_score_cup"].append(cup)
                output["f1_score_disc"].append(disc)
                output["f1_score_avg"].append((cup + disc) / 2)
            else:
                seg_map = h_np[..., 0]
                output["f1_score"].append(_f1(hard[j], y[j], 0))
            output["name"].append(name)
            write_png(out_dir / (name[:-3] + "png"),
                      (seg_map * 255).astype(np.uint8))
    with open(out_dir / "test_result.csv", "w", newline="") as f:
        table = csv.writer(f)
        table.writerow(list(output))
        table.writerows(zip(*output.values()))
    return output


def _augment(cfg, ent, controller, out_dir: Path, seed: int):
    path = os.path.join(cfg.TEST.MODEL_DIR or "", "final_controller_state.pt")
    if cfg.TEST.MODEL_DIR and os.path.exists(path):
        controller.load_state_dict(load_checkpoint(path)["controller"])
    imgs, labels, _ = load_train_arrays(build_dataset(cfg, "train"))
    flat_imgs = torch.as_tensor(
        imgs.reshape((-1,) + imgs.shape[2:])[:N_VIS_IMAGES]).to(
            ent.device).float()
    flat_masks = torch.as_tensor(
        labels.reshape((-1,) + labels.shape[2:])[:N_VIS_IMAGES]).to(
            ent.device).float()
    gen = torch.Generator(ent.device).manual_seed(seed)
    with torch.no_grad():
        policies = policies_to_tensor(
            controller.sample(N_VIS_POLICIES, gen)[0], ent.ctrl_spec)
    n, h, w = flat_imgs.shape[:3]
    draws = draw_policy(n, N_VIS_POLICIES, ent.ctrl_spec.Q, ent.ctrl_spec.L,
                        h, w, torch.Generator(ent.device).manual_seed(
                            seed + 1))
    aug_i, _ = ent.multi_policy(flat_imgs, flat_masks, policies, draws)
    aug_np = aug_i.cpu().numpy().astype(np.uint8)
    for j in range(aug_np.shape[0]):
        for k in range(N_VIS_POLICIES):
            write_png(out_dir / f"sample{j}_{k}.png", aug_np[j, k])
    return {"n_images": int(aug_np.shape[0] * N_VIS_POLICIES)}
