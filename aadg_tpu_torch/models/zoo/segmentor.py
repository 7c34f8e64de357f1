"""Segmentors (port of ``EncoderDecoder.__call__``,
``CascadeEncoderDecoder.__call__`` and ``PointRendSegmentor.__call__``
from ``aadg_tpu/models/zoo/segmentor.py``).

``model(x, dropout=None) -> (logits, feature)``: NHWC images in; the
backbone's features (through the neck, when there is one), the decode
head's logits (refined by each cascade head in turn, or by PointRend's
subdivision in eval) bilinearly resized to the input and returned NHWC,
and the spatial mean of the last feature, (N, ``feat_ch``), the
discriminator's input. ``dropout`` holds the keep mask of each dropout of
the heads' train forward in the order they run (each head takes its
``n_dropout``, one by default); a train-mode forward needs them, eval
applies none. The JAX zoo has no compute dtype: the models run in f32
with autocast off.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .layers import resize
from .point_head import point_rend_refine


def n_dropout(head: nn.Module) -> int:
    return getattr(head, "n_dropout", 1)


class EncoderDecoder(nn.Module):
    """backbone -> [neck] -> decode head, upsampled to the input's size."""

    def __init__(self, backbone: nn.Module, decode_head: nn.Module,
                 feat_ch: int, neck: Optional[nn.Module] = None):
        super().__init__()
        self.backbone = backbone
        if neck is not None:
            self.neck = neck
        self.decode_head = decode_head
        self.feature_dim = feat_ch

    def heads(self):
        return [self.decode_head]

    def _heads(self, feats, masks):
        return self.decode_head(feats, *masks)

    def forward(self, x: torch.Tensor,
                dropout: Optional[Sequence[torch.Tensor]] = None):
        n = sum(n_dropout(h) for h in self.heads())
        masks = tuple(dropout) if dropout is not None else (None,) * n
        # (a meta tensor, which computes shapes only, has no autocast)
        with torch.autocast("cuda" if x.is_cuda else "cpu", enabled=False):
            y = x.float().permute(0, 3, 1, 2)
            feats = self.backbone(y)
            if hasattr(self, "neck"):
                feats = self.neck(feats)
            logits = resize(self._heads(feats, masks), y.shape[2:])
            pooled = torch.mean(feats[-1], dim=(2, 3))
        return logits.permute(0, 2, 3, 1), pooled


class CascadeEncoderDecoder(EncoderDecoder):
    """The decode head, then each cascade head refining the previous
    output: ``head(feats, prev_logits, mask)``."""

    def __init__(self, backbone: nn.Module, decode_head: nn.Module,
                 cascade_heads: Sequence[nn.Module], feat_ch: int):
        super().__init__(backbone, decode_head, feat_ch)
        self.n_cascade = len(cascade_heads)
        for i, h in enumerate(cascade_heads):
            self.add_module(f"cascade_heads_{i}", h)

    def heads(self):
        return [self.decode_head] + [getattr(self, f"cascade_heads_{i}")
                                     for i in range(self.n_cascade)]

    def _heads(self, feats, masks):
        out = self.decode_head(feats, masks[0])
        for i in range(self.n_cascade):
            out = getattr(self, f"cascade_heads_{i}")(feats, out,
                                                       masks[i + 1])
        return out


class PointRendSegmentor(EncoderDecoder):
    """PointRend: backbone -> FPN neck -> a coarse FPNHead; in eval the
    point head refines the coarse logits by ``subdivision_steps`` rounds of
    ``point_rend_refine`` before the resize. Train returns the coarse
    logits (the point head does not run)."""

    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 decode_head: nn.Module, point_head: nn.Module,
                 feat_ch: int, subdivision_steps: int = 2,
                 subdivision_num_points: int = 8196):
        super().__init__(backbone, decode_head, feat_ch, neck)
        self.point_head = point_head
        self.subdivision_steps = subdivision_steps
        self.subdivision_num_points = subdivision_num_points

    def _heads(self, feats, masks):
        coarse = self.decode_head(feats, *masks)
        if self.training:
            return coarse
        return point_rend_refine(self.point_head, feats, coarse,
                                 self.subdivision_steps,
                                 self.subdivision_num_points)
