"""PointRend's point head, eval side (port of ``point_sample``,
``calculate_uncertainty``, ``get_points_test``, ``PointHead`` and
``point_rend_refine`` from ``aadg_tpu/models/zoo/point_head.py``), NCHW
feature maps and (B, P, 2) point coordinates (x, y) in [0, 1].

The train-time point loss (``get_points_train``, the segmentor's
``forward_train_points``) is not ported: no run mode trains it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from ..segformer import dense
from .layers import resize


def point_sample(feat: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear samples (B, P, C) of NCHW ``feat`` at ``coords`` (B, P, 2):
    ``grid_sample``'s ``align_corners=False`` rule (x * W - 0.5) with zero
    padding, as four weighted neighbours."""
    b, c, h, w = feat.shape
    x = coords[..., 0] * w - 0.5
    y = coords[..., 1] * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]
    flat = feat.flatten(2)

    def gather(yy, xx):
        valid = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
        idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long()
        v = torch.gather(flat, 2, idx[:, None].expand(b, c, idx.shape[1]))
        return v.transpose(1, 2) * valid[..., None].to(v.dtype)

    return ((1 - wy) * ((1 - wx) * gather(y0, x0) + wx * gather(y0, x0 + 1))
            + wy * ((1 - wx) * gather(y0 + 1, x0)
                    + wx * gather(y0 + 1, x0 + 1)))


def calculate_uncertainty(logits: torch.Tensor) -> torch.Tensor:
    """Minus the margin between the two largest logits of the last axis
    (minus the logit's magnitude for one class)."""
    if logits.shape[-1] == 1:
        return -torch.abs(logits[..., 0])
    top2 = torch.topk(logits, 2, dim=-1)[0]
    return -(top2[..., 0] - top2[..., 1])


def get_points_test(seg_logits: torch.Tensor,
                    num_points: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``num_points`` most uncertain pixels of NCHW ``seg_logits``:
    (flat indices (B, P), their centres' coordinates (B, P, 2))."""
    b, _, h, w = seg_logits.shape
    unc = calculate_uncertainty(seg_logits.permute(0, 2, 3, 1)).reshape(
        b, h * w)
    idx = torch.topk(unc, num_points, dim=1)[1]
    ys = torch.div(idx, w, rounding_mode="floor").float()
    xs = (idx % w).float()
    return idx, torch.stack([(xs + 0.5) / w, (ys + 0.5) / h], dim=-1)


class PointHead(nn.Module):
    """An MLP over each point's fine features (sampled from the stages of
    ``in_index``) and coarse logits: ``num_fcs`` Dense + ReLU layers, the
    coarse logits concatenated again after each with
    ``coarse_pred_each_layer``, then ``fc_seg``. Runs in eval only here,
    so its dropout never applies."""

    def __init__(self, in_channels: Sequence[int], num_classes: int,
                 channels: int = 256, num_fcs: int = 3,
                 coarse_pred_each_layer: bool = True,
                 in_index: Sequence[int] = (0,)):
        super().__init__()
        self.in_index = tuple(in_index)
        self.num_fcs = num_fcs
        self.coarse_pred_each_layer = coarse_pred_each_layer
        ch = sum(in_channels[i] for i in self.in_index) + num_classes
        for i in range(num_fcs):
            self.add_module(f"fc{i}", dense(ch, channels))
            ch = channels + (num_classes if coarse_pred_each_layer else 0)
        self.fc_seg = dense(ch, num_classes)

    def forward(self, feats, coarse_logits, coords):
        fine = torch.cat([point_sample(feats[i], coords)
                          for i in self.in_index], dim=-1)
        coarse = point_sample(coarse_logits, coords)
        x = torch.cat([fine, coarse], dim=-1)
        for i in range(self.num_fcs):
            x = F.relu(getattr(self, f"fc{i}")(x))
            if self.coarse_pred_each_layer:
                x = torch.cat([x, coarse], dim=-1)
        return self.fc_seg(x)


def point_rend_refine(head, feats, seg_logits: torch.Tensor,
                      subdivision_steps: int = 2,
                      subdivision_num_points: int = 8196) -> torch.Tensor:
    """Iterative subdivision: per step a x2 bilinear upsample of the NCHW
    logits, then the ``min(subdivision_num_points, h * w)`` most uncertain
    pixels re-scored by ``head(feats, logits, coords)`` and written back."""
    for _ in range(subdivision_steps):
        b, c, h, w = seg_logits.shape
        seg_logits = resize(seg_logits, (2 * h, 2 * w))
        h, w = 2 * h, 2 * w
        idx, coords = get_points_test(seg_logits, min(subdivision_num_points,
                                                      h * w))
        refined = head(feats, seg_logits, coords)              # (B, P, C)
        seg_logits = seg_logits.flatten(2).scatter(
            2, idx[:, None].expand(b, c, idx.shape[1]),
            refined.transpose(1, 2)).reshape(b, c, h, w)
    return seg_logits
