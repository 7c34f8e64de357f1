"""Decode heads of the conv/pyramid-pooling family (port of
``aadg_tpu/models/zoo/heads.py``: ``ClsSeg``, FCN, separable FCN, PSP,
ASPP, separable ASPP (DeepLabV3+), UPer, FPN and Lite R-ASPP), NCHW
inside.

A head takes the backbone's feature list (``in_channels`` are its widths),
selects or merges stages by ``in_index``/``input_transform`` and ends with
``ClsSeg``: dropout and a 1x1 classifier. Heads return logits at feature
resolution; the segmentor upsamples them. The dropout masks are inputs
(``forward(feats, mask)``), drawn with the step's other draws; a head
with more than one dropout in its train forward takes one mask per
dropout, in the order they run, and says how many in ``n_dropout``.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from ..mobilenetv2 import conv
from ..segformer import keep_where
from .layers import (ConvModule, DepthwiseSeparableConvModule,
                     adaptive_avg_pool, input_channels, resize,
                     transform_inputs)

DROPOUT = 0.1   # BaseDecodeHead's dropout_ratio


class Dropout(nn.Module):
    """Dropout whose keep mask is an input: in train mode ``mask`` is the
    (N, h, w, C) keep mask of ``x`` (True keeps); eval applies none."""

    def __init__(self, dropout_ratio: float = DROPOUT):
        super().__init__()
        self.dropout_ratio = dropout_ratio

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        if not (self.training and self.dropout_ratio > 0):
            return x
        if mask is None:
            raise ValueError("a train-mode forward needs the dropout mask "
                             "of each dropout's input")
        return keep_where(x, mask.permute(0, 3, 1, 2), self.dropout_ratio)


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


class DepthwiseSeparableFCNHead(nn.Module):
    """The FCN head with depthwise separable convolutions (Fast-SCNN's
    decode head): ``num_convs`` of them, an optional ``conv_cat`` over the
    input and their output, then ClsSeg."""

    def __init__(self, in_channels: Sequence[int], num_classes: int,
                 channels: int = 128, num_convs: int = 1,
                 concat_input: bool = False, in_index: Any = -1,
                 input_transform: Optional[str] = None,
                 dropout_ratio: float = DROPOUT):
        super().__init__()
        self.in_index, self.input_transform = in_index, input_transform
        self.num_convs, self.concat_input = num_convs, concat_input
        in_ch = input_channels(in_channels, in_index, input_transform)
        ch = in_ch
        for i in range(num_convs):
            self.add_module(f"convs_{i}",
                            DepthwiseSeparableConvModule(ch, channels, 3))
            ch = channels
        if concat_input:
            self.conv_cat = DepthwiseSeparableConvModule(in_ch + ch,
                                                         channels, 3)
            ch = channels
        self.cls = ClsSeg(ch, num_classes, dropout_ratio)

    def forward(self, inputs, mask=None):
        x = transform_inputs(inputs, self.in_index, self.input_transform)
        feats = x
        for i in range(self.num_convs):
            feats = getattr(self, f"convs_{i}")(feats)
        if self.concat_input:
            feats = self.conv_cat(torch.cat([x, feats], dim=1))
        return self.cls(feats, mask)


class ASPPModule(nn.Module):
    """Parallel branches: a 1x1 ConvModule for dilation 1, a dilated 3x3
    ConvModule (or a depthwise separable one with ``separable``) for the
    others."""

    def __init__(self, in_ch: int, dilations: Tuple[int, ...],
                 channels: int, separable: bool = False):
        super().__init__()
        self.n = len(dilations)
        for i, d in enumerate(dilations):
            if d == 1 or not separable:
                m = ConvModule(in_ch, channels, 1 if d == 1 else 3,
                               dilation=d)
            else:
                m = DepthwiseSeparableConvModule(in_ch, channels, 3,
                                                 dilation=d)
            self.add_module(f"branch_{i}", m)

    def forward(self, x):
        return [getattr(self, f"branch_{i}")(x) for i in range(self.n)]


class ASPPHead(nn.Module):
    """DeepLabV3's head: the image-pooled context (a 1x1 ConvModule on the
    global mean, spread over the map) and the ASPP branches at dilations
    (1, 12, 24, 36), concatenated, a 3x3 ConvModule bottleneck, ClsSeg.
    With ``separable`` the dilated branches are depthwise separable and,
    when ``c1_channels`` > 0, the bottleneck's output is upsampled to the
    ``c1_in_index`` stage and fused with its 1x1 projection through two
    depthwise separable 3x3 convs (``DepthwiseSeparableASPPHead``)."""

    def __init__(self, in_channels: Sequence[int], num_classes: int,
                 channels: int = 512,
                 dilations: Tuple[int, ...] = (1, 12, 24, 36),
                 in_index: Any = -1, input_transform: Optional[str] = None,
                 dropout_ratio: float = DROPOUT, separable: bool = False,
                 c1_in_index: int = 0, c1_channels: int = 0):
        super().__init__()
        self.in_index, self.input_transform = in_index, input_transform
        self.c1_in_index, self.c1_channels = c1_in_index, c1_channels
        self.separable = separable
        in_ch = input_channels(in_channels, in_index, input_transform)
        self.image_pool = ConvModule(in_ch, channels, 1)
        self.aspp = ASPPModule(in_ch, dilations, channels, separable)
        self.bottleneck = ConvModule((len(dilations) + 1) * channels,
                                     channels, 3)
        ch = channels
        if separable:
            if c1_channels > 0:
                self.c1_bottleneck = ConvModule(in_channels[c1_in_index],
                                                c1_channels, 1)
                ch += c1_channels
            self.sep_bottleneck_0 = DepthwiseSeparableConvModule(
                ch, channels, 3)
            self.sep_bottleneck_1 = DepthwiseSeparableConvModule(
                channels, channels, 3)
        self.cls = ClsSeg(channels, num_classes, dropout_ratio)

    def forward(self, inputs, mask=None):
        x = transform_inputs(inputs, self.in_index, self.input_transform)
        pool = self.image_pool(adaptive_avg_pool(x, 1))
        feats = self.bottleneck(torch.cat(
            [resize(pool, x.shape[2:])] + self.aspp(x), dim=1))
        if self.separable:
            if self.c1_channels > 0:
                c1 = self.c1_bottleneck(inputs[self.c1_in_index])
                feats = torch.cat([resize(feats, c1.shape[2:]), c1], dim=1)
            feats = self.sep_bottleneck_1(self.sep_bottleneck_0(feats))
        return self.cls(feats, mask)


def DepthwiseSeparableASPPHead(in_channels: Sequence[int], num_classes: int,
                               channels: int = 512, **kw) -> ASPPHead:
    """DeepLabV3+'s head: separable ASPP and the 48-channel stride-4 skip
    (stage ``c1_in_index`` 0)."""
    kw.setdefault("c1_channels", 48)
    return ASPPHead(in_channels, num_classes, channels, separable=True, **kw)


class UPerHead(nn.Module):
    """UPerNet's head: PPM on the top stage and a 3x3 bottleneck, 1x1
    laterals of the other stages summed top-down (bilinear), a 3x3
    ConvModule on each but the top, all resized to the finest stage,
    concatenated, a 3x3 fuse, ClsSeg."""

    def __init__(self, in_channels: Sequence[int], num_classes: int,
                 channels: int = 512,
                 pool_scales: Tuple[int, ...] = (1, 2, 3, 6),
                 in_index: Tuple[int, ...] = (0, 1, 2, 3),
                 dropout_ratio: float = DROPOUT):
        super().__init__()
        self.in_index = tuple(in_index)
        chans = [in_channels[i] for i in self.in_index]
        self.ppm = PPM(pool_scales, chans[-1], channels)
        self.psp_bottleneck = ConvModule(
            chans[-1] + len(pool_scales) * channels, channels, 3)
        for i, c in enumerate(chans[:-1]):
            self.add_module(f"lateral_{i}", ConvModule(c, channels, 1))
            self.add_module(f"fpn_conv_{i}", ConvModule(channels, channels))
        self.fpn_bottleneck = ConvModule(len(chans) * channels, channels, 3)
        self.cls = ClsSeg(channels, num_classes, dropout_ratio)

    def forward(self, inputs, mask=None):
        xs = [inputs[i] for i in self.in_index]
        top = xs[-1]
        psp = self.psp_bottleneck(torch.cat([top] + self.ppm(top), dim=1))
        n = len(xs)
        laterals = [getattr(self, f"lateral_{i}")(x)
                    for i, x in enumerate(xs[:-1])] + [psp]
        for i in range(n - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize(
                laterals[i], laterals[i - 1].shape[2:])
        outs = [getattr(self, f"fpn_conv_{i}")(laterals[i])
                for i in range(n - 1)] + [laterals[-1]]
        outs = [resize(o, outs[0].shape[2:]) for o in outs]
        return self.cls(self.fpn_bottleneck(torch.cat(outs, dim=1)), mask)


class FPNHead(nn.Module):
    """Semantic FPN's head: stage i runs ``max(1, log2(s_i / s_0))`` 3x3
    ConvModules, each followed (when its stride differs from the finest
    stage's) by a x2 bilinear upsample clamped to the finest stage's size;
    the stages are summed, then ClsSeg. ``feature_strides`` are the true
    strides of the stages read (the builder probes the backbone), so the
    parameters do not depend on the input size."""

    def __init__(self, in_channels: Sequence[int], num_classes: int,
                 channels: int = 128,
                 in_index: Tuple[int, ...] = (0, 1, 2, 3),
                 feature_strides: Tuple[int, ...] = (4, 8, 16, 32),
                 dropout_ratio: float = DROPOUT):
        super().__init__()
        if len(in_index) != len(feature_strides):
            raise ValueError("FPNHead needs one stride per input stage")
        self.in_index = tuple(in_index)
        self.feature_strides = tuple(feature_strides)
        s0 = int(math.log2(feature_strides[0]))
        self.rounds = []
        for i, idx in enumerate(self.in_index):
            n = max(1, int(math.log2(feature_strides[i])) - s0)
            self.rounds.append(n)
            for k in range(n):
                self.add_module(f"scale_head_{i}_{k}", ConvModule(
                    in_channels[idx] if k == 0 else channels, channels, 3))
        self.cls = ClsSeg(channels, num_classes, dropout_ratio)

    def forward(self, inputs, mask=None):
        xs = [inputs[i] for i in self.in_index]
        h0, w0 = xs[0].shape[2:]
        out = None
        for i, x in enumerate(xs):
            for k in range(self.rounds[i]):
                x = getattr(self, f"scale_head_{i}_{k}")(x)
                if self.feature_strides[i] != self.feature_strides[0]:
                    x = resize(x, (min(h0, x.shape[2] * 2),
                                   min(w0, x.shape[3] * 2)))
            out = x if out is None else out + x
        return self.cls(out, mask)
