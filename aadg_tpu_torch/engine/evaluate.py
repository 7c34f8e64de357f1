"""Validation (port of ``aadg_tpu/engine/evaluate.py:32-131``).

The model runs in eval mode (BatchNorm on its running statistics) under
the training autocast on the model's device. Optic: sigmoid probabilities
thresholded at 0.75, cup and disc dice per sample weighted by the test
store's 0/1 weights, and per-image hd95 on the host with the penalty of
100 for an empty mask. RVS: threshold 0.5, the weighted dice, and the
accuracy, AUROC, specificity and sensitivity over the ROI pixels of the
batch's real samples, on the host. Metrics aggregate per batch weighted by
its number of real samples.
"""

from __future__ import annotations

from typing import Dict

import torch

from .. import metrics as M
from ..data.stores import TestStore
from ..data.transforms import (normalize_image, optic_mask_to_multilabel,
                               vessel_mask_to_binary)
from .state import Entities


def eval_forward(ent: Entities, model: torch.nn.Module,
                 imgs: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) uint8 images -> (N, H, W, classes) f32 sigmoid
    probabilities. Leaves the model in eval mode; the train steps put it
    back in train mode."""
    model.eval()
    with torch.no_grad(), ent.autocast():
        logits, _ = model(normalize_image(imgs.float()))
    return torch.sigmoid(logits.float())


def validate_optic(ent: Entities, model: torch.nn.Module, store: TestStore,
                   batch_size: int = 8, threshold: float = 0.75
                   ) -> Dict[str, float]:
    n_pad = store.images.shape[0]
    cup_dsc = disc_dsc = cup_hd = disc_hd = 0.0
    n_total = 0
    for lo in range(0, n_pad, batch_size):
        hi = min(lo + batch_size, n_pad)
        # the store pads at the end: rows past n_real weigh 0
        n_real = max(0, min(hi, store.n_real) - lo)
        if n_real == 0:
            break
        soft = eval_forward(ent, model, store.images[lo:hi])
        hard = (soft > threshold).float()
        y = optic_mask_to_multilabel(store.labels[lo:hi].float())
        w = store.weights[lo:hi]
        scores = torch.stack([M.samplewise_f1(hard[..., c], y[..., c],
                                              weight=w)[1] for c in (0, 1)])
        c, dd = scores.tolist()
        cup_dsc += c * n_real
        disc_dsc += dd * n_real
        hard_np = hard[:n_real].cpu().numpy() > 0
        y_np = y[:n_real].cpu().numpy() > 0
        for j in range(n_real):
            cup_hd += M.hd95_with_penalty(hard_np[j, ..., 0], y_np[j, ..., 0])
            disc_hd += M.hd95_with_penalty(hard_np[j, ..., 1],
                                           y_np[j, ..., 1])
        n_total += n_real
    return {"cup_dsc": cup_dsc / n_total, "disc_dsc": disc_dsc / n_total,
            "cup_hd": cup_hd / n_total, "disc_hd": disc_hd / n_total}


def validate_rvs(ent: Entities, model: torch.nn.Module, store: TestStore,
                 batch_size: int = 8, threshold: float = 0.5
                 ) -> Dict[str, float]:
    if store.rois is None:
        raise ValueError("rvs validation needs the test store's ROIs")
    n_pad = store.images.shape[0]
    sums = {k: 0.0 for k in ("dsc", "acc", "aucroc", "sp", "se")}
    n_total = 0
    for lo in range(0, n_pad, batch_size):
        hi = min(lo + batch_size, n_pad)
        n_real = max(0, min(hi, store.n_real) - lo)
        if n_real == 0:
            break
        soft = eval_forward(ent, model, store.images[lo:hi])
        y = vessel_mask_to_binary(store.labels[lo:hi].float())
        hard = (soft > threshold).float()
        dsc = float(M.samplewise_f1(hard[..., 0], y[..., 0],
                                    weight=store.weights[lo:hi])[1])
        # ROI pixels of the real samples
        roi = (store.rois[lo:hi] != 0).cpu().numpy()
        roi[n_real:] = False
        soft_np = soft[..., 0].cpu().numpy()
        y_np = y[..., 0].cpu().numpy()
        sums["dsc"] += dsc * n_real
        sums["acc"] += M.accuracy_score(soft_np, y_np, roi) * n_real
        sums["aucroc"] += M.auroc(soft_np, y_np, roi) * n_real
        sums["sp"] += M.specificity(soft_np, y_np, roi) * n_real
        sums["se"] += M.sensitivity(soft_np, y_np, roi) * n_real
        n_total += n_real
    return {k: v / n_total for k, v in sums.items()}


def validate(ent: Entities, model: torch.nn.Module, store: TestStore,
             batch_size: int = 8) -> Dict[str, float]:
    if ent.dataset_name == "optic":
        return validate_optic(ent, model, store, batch_size)
    return validate_rvs(ent, model, store, batch_size)
