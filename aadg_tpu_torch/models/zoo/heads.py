"""Decode heads of the conv/pyramid-pooling family (port of
``aadg_tpu/models/zoo/heads.py``: ``ClsSeg``, ``FCNHead``, ``PPM``,
``PSPHead`` and ``LRASPPHead``), NCHW inside.

A head takes the backbone's feature list (``in_channels`` are its widths),
selects or merges stages by ``in_index``/``input_transform`` and ends with
``ClsSeg``: dropout and a 1x1 classifier. Heads return logits at feature
resolution; the segmentor upsamples them. The dropout mask is an input
(``forward(feats, mask)``), drawn with the step's other draws.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from ..mobilenetv2 import conv
from ..segformer import keep_where
from .layers import (ConvModule, adaptive_avg_pool, input_channels, resize,
                     transform_inputs)

DROPOUT = 0.1   # BaseDecodeHead's dropout_ratio


class ClsSeg(nn.Module):
    """Dropout then a 1x1 classifier with bias. In train mode ``mask`` is
    the (N, h, w, C) keep mask of ``x`` (True keeps); eval applies none."""

    def __init__(self, in_ch: int, num_classes: int,
                 dropout_ratio: float = DROPOUT):
        super().__init__()
        self.dropout_ratio = dropout_ratio
        self.conv_seg = conv(in_ch, num_classes, 1, bias=True)

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        if self.training and self.dropout_ratio > 0:
            if mask is None:
                raise ValueError("a train-mode forward needs the dropout "
                                 "mask of the classifier's input")
            x = keep_where(x, mask.permute(0, 3, 1, 2), self.dropout_ratio)
        return self.conv_seg(x)


class FCNHead(nn.Module):
    """``num_convs`` ConvModules of ``channels`` (and a ``conv_cat`` over
    the input and their output with ``concat_input``), then ClsSeg."""

    def __init__(self, in_channels: Sequence[int], num_classes: int,
                 channels: int = 256, num_convs: int = 2,
                 concat_input: bool = True, kernel: int = 3,
                 in_index: Any = -1, input_transform: Optional[str] = None,
                 dropout_ratio: float = DROPOUT):
        super().__init__()
        self.in_index, self.input_transform = in_index, input_transform
        self.num_convs, self.concat_input = num_convs, concat_input
        in_ch = input_channels(in_channels, in_index, input_transform)
        ch = in_ch
        for i in range(num_convs):
            self.add_module(f"convs_{i}", ConvModule(ch, channels, kernel))
            ch = channels
        if num_convs and concat_input:
            self.conv_cat = ConvModule(in_ch + channels, channels, kernel)
        self.cls = ClsSeg(ch, num_classes, dropout_ratio)

    def forward(self, inputs, mask=None):
        x = transform_inputs(inputs, self.in_index, self.input_transform)
        feats = x
        for i in range(self.num_convs):
            feats = getattr(self, f"convs_{i}")(feats)
        if self.num_convs and self.concat_input:
            feats = self.conv_cat(torch.cat([x, feats], dim=1))
        return self.cls(feats, mask)


class PPM(nn.Module):
    """Pyramid pooling: per scale an adaptive average pool, a 1x1
    ConvModule and a bilinear resize back to the input's size."""

    def __init__(self, pool_scales: Tuple[int, ...], in_ch: int,
                 channels: int):
        super().__init__()
        self.pool_scales = tuple(pool_scales)
        for i in range(len(pool_scales)):
            self.add_module(f"pool_{i}", ConvModule(in_ch, channels, 1))

    def forward(self, x):
        return [resize(getattr(self, f"pool_{i}")(adaptive_avg_pool(x, s)),
                       x.shape[2:])
                for i, s in enumerate(self.pool_scales)]


class PSPHead(nn.Module):
    """PPM(1, 2, 3, 6), concatenated after the input, a 3x3 ConvModule
    bottleneck, then ClsSeg."""

    def __init__(self, in_channels: Sequence[int], num_classes: int,
                 channels: int = 512,
                 pool_scales: Tuple[int, ...] = (1, 2, 3, 6),
                 in_index: Any = -1, input_transform: Optional[str] = None,
                 dropout_ratio: float = DROPOUT):
        super().__init__()
        self.in_index, self.input_transform = in_index, input_transform
        in_ch = input_channels(in_channels, in_index, input_transform)
        self.ppm = PPM(pool_scales, in_ch, channels)
        self.bottleneck = ConvModule(in_ch + len(pool_scales) * channels,
                                     channels, 3)
        self.cls = ClsSeg(channels, num_classes, dropout_ratio)

    def forward(self, inputs, mask=None):
        x = transform_inputs(inputs, self.in_index, self.input_transform)
        feats = self.bottleneck(torch.cat([x] + self.ppm(x), dim=1))
        return self.cls(feats, mask)


class LRASPPHead(nn.Module):
    """Lite R-ASPP: the top stage times a sigmoid gate from pooled context,
    then upsampled and fused with 1x1 projections of the skip stages.

    The gate pools with ``AvgPool2d(49, stride=(16, 20))`` when the top
    stage is at least 49 x 49, as the reference does; below that (torch's
    pool would fail) it pools globally, the kernel-covers-the-grid limit."""

    def __init__(self, in_channels: Sequence[int], num_classes: int,
                 channels: int = 128,
                 branch_channels: Tuple[int, ...] = (32, 64),
                 in_index: Tuple[int, ...] = (0, 1, 2),
                 dropout_ratio: float = DROPOUT):
        super().__init__()
        self.in_index = tuple(in_index)
        self.branch_channels = tuple(branch_channels)
        chans = [in_channels[i] for i in self.in_index]
        self.image_pool = ConvModule(chans[-1], channels, 1, norm=False,
                                     act="sigmoid", bias=False)
        self.aspp_conv = ConvModule(chans[-1], channels, 1)
        self.conv_up_input = conv(channels, channels, 1, bias=True)
        for i, bc in enumerate(branch_channels):
            self.add_module(f"convs_{i}", conv(chans[i], bc, 1))
            self.add_module(f"conv_ups_{i}",
                            ConvModule(channels + bc, channels, 1))
        self.cls = ClsSeg(channels, num_classes, dropout_ratio)

    def forward(self, inputs, mask=None):
        xs = [inputs[i] for i in self.in_index]
        x = xs[-1]
        if x.shape[2] >= 49 and x.shape[3] >= 49:
            gate = F.avg_pool2d(x, 49, stride=(16, 20))
        else:
            gate = torch.mean(x, dim=(2, 3), keepdim=True)
        gate = self.image_pool(gate)
        x = self.aspp_conv(x) * resize(gate, x.shape[2:])
        x = self.conv_up_input(x)
        for i in range(len(self.branch_channels) - 1, -1, -1):
            x = resize(x, xs[i].shape[2:])
            branch = getattr(self, f"convs_{i}")(xs[i])
            x = getattr(self, f"conv_ups_{i}")(torch.cat([x, branch], dim=1))
        return self.cls(x, mask)
