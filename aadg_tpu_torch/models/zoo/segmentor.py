"""Segmentors (port of ``EncoderDecoder.__call__`` and
``CascadeEncoderDecoder.__call__`` from ``aadg_tpu/models/zoo/segmentor.py``).

``model(x, dropout=None) -> (logits, feature)``: NHWC images in; the decode
head's logits (refined by each cascade head in turn) bilinearly resized to
the input and returned NHWC, and the spatial mean of the backbone's last
feature, (N, ``feat_ch``), the discriminator's input. ``dropout`` holds
the keep mask of each head's classifier input in the order the heads run
(``ClsSeg``); a train-mode forward needs them, eval applies none. The JAX
zoo has no compute dtype: the models run in f32 with autocast off.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .layers import resize


class EncoderDecoder(nn.Module):
    """backbone -> decode head, upsampled to the input's size."""

    def __init__(self, backbone: nn.Module, decode_head: nn.Module,
                 feat_ch: int):
        super().__init__()
        self.backbone = backbone
        self.decode_head = decode_head
        self.feature_dim = feat_ch

    def _heads(self, feats, dropout):
        return self.decode_head(feats, dropout[0])

    def forward(self, x: torch.Tensor,
                dropout: Optional[Sequence[torch.Tensor]] = None):
        masks = dropout if dropout is not None else (None,) * 2
        # (a meta tensor, which computes shapes only, has no autocast)
        with torch.autocast("cuda" if x.is_cuda else "cpu", enabled=False):
            y = x.float().permute(0, 3, 1, 2)
            feats = self.backbone(y)
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

    def _heads(self, feats, dropout):
        out = self.decode_head(feats, dropout[0])
        for i in range(self.n_cascade):
            out = getattr(self, f"cascade_heads_{i}")(feats, out,
                                                       dropout[i + 1])
        return out
