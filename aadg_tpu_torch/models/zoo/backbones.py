"""Zoo backbones (port of ``aadg_tpu/models/zoo/backbones.py``), NCHW
inside. Each returns a list of features and names its widths in
``out_channels``:

- ``ResNetV1c`` (50, 101): deep 3x3 stem, dilations (1, 1, 2, 4), output
  stride 8; four stages. ``ResNeXt`` is the same network with grouped
  3x3 convolutions (32 groups of 4 channels per 64 planes).
- ``ResNeSt`` (50, 101): the same stages of split-attention bottlenecks
  (radix 2) with avg-down shortcuts.
- ``HRNet`` (W18, W32, W48): four parallel branches at strides 4/8/16/32
  with full cross-resolution fusion.
- ``MobileNetV3`` ('large'/'small'): inverted residuals with
  squeeze-excite and hard-swish; the three taps the LRASPP head reads.
- ``FastSCNN``: learning-to-downsample, a global feature extractor with a
  pyramid pooling module, and feature fusion; ``[higher (1/8), lower
  (1/32), fusion (1/8)]``.
- ``CGNet`` (M3N21): context-guided blocks with per-channel PReLUs and
  input injection; three stages at strides 2, 4 and 8.
- ``UNetBackbone`` (S5-D16): mmseg's configurable UNet; the bottleneck
  and the four decoder outputs, coarse to fine.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from ..mobilenetv2 import BatchNorm, conv
from ..segformer import dense
from .layers import (ConvModule, DepthwiseSeparableConvModule,
                     adaptive_avg_pool, resize)


class Bottleneck(nn.Module):
    """ResNet bottleneck (1x1, dilated 3x3 carrying the stride and split in
    ``groups``, 1x1 to ``4 planes``), with a strided 1x1 projection when
    the shape changes. The inner width is ``planes * base_width / 64``
    per group (ResNeXt); 64 and one group is ResNet's ``planes``."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 dilation: int = 1, groups: int = 1, base_width: int = 64):
        super().__init__()
        out_ch = planes * 4
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = conv(in_ch, width, 1)
        self.bn1 = BatchNorm(width)
        self.conv2 = conv(width, width, 3, stride, groups=groups,
                          dilation=dilation, padding=dilation)
        self.bn2 = BatchNorm(width)
        self.conv3 = conv(width, out_ch, 1)
        self.bn3 = BatchNorm(out_ch)
        self.down = in_ch != out_ch or stride != 1
        if self.down:
            self.down_conv = conv(in_ch, out_ch, 1, stride, padding=0)
            self.down_bn = BatchNorm(out_ch)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.down:
            x = self.down_bn(self.down_conv(x))
        return F.relu(x + y)


class _ResStages(nn.Module):
    """A deep stem (three 3x3 convs of widths ``stem``, the first with
    stride 2) and a 3x3 max pool, then four stages of ``block(in, planes,
    stride, dilation)`` bottlenecks, (3, 4, 6, 3) at depth 50 and (3, 4,
    23, 3) at 101, at planes 64 x 2^s; returns each stage's output."""

    blocks = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}

    def __init__(self, depth: int, stem: Tuple[int, ...],
                 dilations: Tuple[int, ...], strides: Tuple[int, ...],
                 block):
        super().__init__()
        ch = 3
        for i, out in enumerate(stem):
            self.add_module(f"stem{i}", conv(ch, out, 3, 2 if i == 0 else 1,
                                             padding=1))
            self.add_module(f"stem_bn{i}", BatchNorm(out))
            ch = out
        self.stage_blocks = self.blocks[depth]
        self.out_channels = []
        for s, n in enumerate(self.stage_blocks):
            planes = 64 * 2 ** s
            for b in range(n):
                self.add_module(f"layer{s + 1}_{b}", block(
                    ch, planes, strides[s] if b == 0 else 1, dilations[s]))
                ch = planes * 4
            self.out_channels.append(ch)

    def forward(self, x) -> List[torch.Tensor]:
        for i in range(3):
            x = F.relu(getattr(self, f"stem_bn{i}")(
                getattr(self, f"stem{i}")(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        feats = []
        for s, n in enumerate(self.stage_blocks):
            for b in range(n):
                x = getattr(self, f"layer{s + 1}_{b}")(x)
            feats.append(x)
        return feats


class ResNetV1c(_ResStages):
    """mmseg's default encoder: a (32, 32, 64) stem, then stages of
    bottlenecks with strides (1, 2, 1, 1) and dilations (1, 1, 2, 4)."""

    def __init__(self, depth: int = 50, groups: int = 1,
                 base_width: int = 64,
                 dilations: Tuple[int, ...] = (1, 1, 2, 4),
                 strides: Tuple[int, ...] = (1, 2, 1, 1)):
        super().__init__(depth, (32, 32, 64), dilations, strides,
                         lambda ch, planes, s, d: Bottleneck(
                             ch, planes, s, d, groups, base_width))


def ResNeXt(depth: int = 50, groups: int = 32,
            base_width: int = 4) -> ResNetV1c:
    """ResNeXt (32x4d): ResNetV1c with grouped bottlenecks."""
    return ResNetV1c(depth, groups, base_width)


class SplitAttentionConv(nn.Module):
    """Split attention (ResNeSt's SplAtConv2d): a 3x3 conv over
    ``groups * radix`` groups to ``radix`` splits of ``channels``, BatchNorm
    and ReLU; the splits' sum pooled globally, ``fc1`` -> BatchNorm -> ReLU
    -> ``fc2``; then a softmax over the radix (the JAX layout: ``fc2``'s
    output read as (radix, groups, channels / groups), which equals mmcv's
    rSoftMax only at one group) weights the splits' sum."""

    def __init__(self, in_ch: int, channels: int, radix: int = 2,
                 groups: int = 1, dilation: int = 1):
        super().__init__()
        self.radix, self.groups, self.channels = radix, groups, channels
        self.conv = conv(in_ch, channels * radix, 3, groups=groups * radix,
                         dilation=dilation, padding=dilation)
        self.bn0 = BatchNorm(channels * radix)
        inter = max(channels * radix // 4, 32)
        self.fc1 = dense(channels, inter)
        self.bn1 = BatchNorm(inter)
        self.fc2 = dense(inter, channels * radix)

    def forward(self, x):
        r, g, c = self.radix, self.groups, self.channels
        y = F.relu(self.bn0(self.conv(x)))
        b, _, h, w = y.shape
        splits = y.view(b, r, c, h, w)          # radix-major channels
        gap = splits.sum(1).mean(dim=(2, 3))
        a = F.relu(self.bn1(self.fc1(gap)))
        a = torch.softmax(self.fc2(a).view(b, r, g, c // g), dim=1)
        return (splits * a.reshape(b, r, c, 1, 1)).sum(1)


class ResNeStBottleneck(nn.Module):
    """1x1, split-attention 3x3 (carrying the dilation), a 3x3 average pool
    with the stride after it (avd), 1x1 to ``4 planes``; the shortcut
    average-pools by the stride (flooring) before its 1x1 projection."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 dilation: int = 1, radix: int = 2):
        super().__init__()
        out_ch = planes * 4
        self.stride = stride
        self.conv1 = conv(in_ch, planes, 1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = SplitAttentionConv(planes, planes, radix,
                                        dilation=dilation)
        self.conv3 = conv(planes, out_ch, 1)
        self.bn3 = BatchNorm(out_ch)
        self.down = in_ch != out_ch or stride != 1
        if self.down:
            self.down_conv = conv(in_ch, out_ch, 1)
            self.down_bn = BatchNorm(out_ch)

    def forward(self, x):
        y = self.conv2(F.relu(self.bn1(self.conv1(x))))
        if self.stride > 1:
            y = F.avg_pool2d(y, 3, self.stride, 1)
        y = self.bn3(self.conv3(y))
        if self.down:
            if self.stride != 1:
                x = F.avg_pool2d(x, self.stride, self.stride)
            x = self.down_bn(self.down_conv(x))
        return F.relu(x + y)


class ResNeSt(_ResStages):
    """ResNeSt: ResNetV1c's stages of split-attention bottlenecks, with a
    (32, 32, 64) stem at depth 50 and (64, 64, 128) at 101."""

    def __init__(self, depth: int = 50, radix: int = 2,
                 dilations: Tuple[int, ...] = (1, 1, 2, 4),
                 strides: Tuple[int, ...] = (1, 2, 1, 1)):
        super().__init__(depth,
                         (32, 32, 64) if depth == 50 else (64, 64, 128),
                         dilations, strides,
                         lambda ch, planes, s, d: ResNeStBottleneck(
                             ch, planes, s, d, radix))


class BasicBlock(nn.Module):
    def __init__(self, in_ch: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = conv(in_ch, planes, 3, stride, padding=1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = conv(planes, planes, 3, padding=1)
        self.bn2 = BatchNorm(planes)
        self.down = in_ch != planes or stride != 1
        if self.down:
            self.down_conv = conv(in_ch, planes, 1, stride, padding=0)
            self.down_bn = BatchNorm(planes)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.down:
            x = self.down_bn(self.down_conv(x))
        return F.relu(x + y)


class HRModule(nn.Module):
    """One exchange unit: ``num_blocks`` BasicBlocks per branch, then every
    branch sums every other, upsampled (1x1 conv, BatchNorm, bilinear) or
    downsampled (a chain of stride-2 3x3 convs)."""

    def __init__(self, channels: Sequence[int], num_blocks: int = 4):
        super().__init__()
        self.channels = tuple(channels)
        self.num_blocks = num_blocks
        n = len(channels)
        for i, ch in enumerate(channels):
            for b in range(num_blocks):
                self.add_module(f"branch{i}_block{b}", BasicBlock(ch, ch))
        for i in range(n):
            for j in range(n):
                if j > i:
                    self.add_module(f"fuse_{i}_{j}_conv",
                                    conv(channels[j], channels[i], 1))
                    self.add_module(f"fuse_{i}_{j}_bn",
                                    BatchNorm(channels[i]))
                for k in range(i - j):
                    out = channels[i] if k == i - j - 1 else channels[j]
                    self.add_module(f"fuse_{i}_{j}_conv{k}",
                                    conv(channels[j], out, 3, 2, padding=1))
                    self.add_module(f"fuse_{i}_{j}_bn{k}", BatchNorm(out))

    def forward(self, xs):
        n = len(self.channels)
        ys = []
        for i in range(n):
            y = xs[i]
            for b in range(self.num_blocks):
                y = getattr(self, f"branch{i}_block{b}")(y)
            ys.append(y)
        fused = []
        for i in range(n):
            acc = None
            for j in range(n):
                y = ys[j]
                if j > i:
                    y = getattr(self, f"fuse_{i}_{j}_bn")(
                        getattr(self, f"fuse_{i}_{j}_conv")(y))
                    y = resize(y, ys[i].shape[2:])
                for k in range(i - j):
                    y = getattr(self, f"fuse_{i}_{j}_bn{k}")(
                        getattr(self, f"fuse_{i}_{j}_conv{k}")(y))
                    if k < i - j - 1:
                        y = F.relu(y)
                acc = y if acc is None else acc + y
            fused.append(F.relu(acc))
        return fused


class HRNet(nn.Module):
    """HRNetV2: two stride-2 3x3 stem convs, four bottlenecks at 64, then
    stages of (1, 4, 3) exchange units over 2, 3 and 4 branches of widths
    (w, 2w, 4w, 8w); returns the four branches."""

    def __init__(self, width: int = 18,
                 stage_modules: Tuple[int, ...] = (1, 4, 3),
                 num_blocks: int = 4):
        super().__init__()
        chans = (width, 2 * width, 4 * width, 8 * width)
        self.stage_modules = stage_modules
        self.out_channels = list(chans)
        self.stem0 = conv(3, 64, 3, 2, padding=1)
        self.stem_bn0 = BatchNorm(64)
        self.stem1 = conv(64, 64, 3, 2, padding=1)
        self.stem_bn1 = BatchNorm(64)
        ch = 64
        for b in range(4):
            self.add_module(f"layer1_{b}", Bottleneck(ch, 64))
            ch = 256
        self.transition1_0 = ConvModule(ch, chans[0], 3)
        self.transition1_1 = ConvModule(ch, chans[1], 3, stride=2)
        for stage, n_mod in enumerate(stage_modules):
            n_br = stage + 2
            for m in range(n_mod):
                self.add_module(f"stage{stage + 2}_module{m}",
                                HRModule(chans[:n_br], num_blocks))
            if stage < len(stage_modules) - 1:
                self.add_module(f"transition{stage + 2}_{n_br}", ConvModule(
                    chans[n_br - 1], chans[n_br], 3, stride=2))

    def forward(self, x) -> List[torch.Tensor]:
        x = F.relu(self.stem_bn0(self.stem0(x)))
        x = F.relu(self.stem_bn1(self.stem1(x)))
        for b in range(4):
            x = getattr(self, f"layer1_{b}")(x)
        xs = [self.transition1_0(x), self.transition1_1(x)]
        for stage, n_mod in enumerate(self.stage_modules):
            n_br = stage + 2
            for m in range(n_mod):
                xs = getattr(self, f"stage{stage + 2}_module{m}")(xs)
            if stage < len(self.stage_modules) - 1:
                xs = xs + [getattr(self, f"transition{stage + 2}_{n_br}")(
                    xs[-1])]
        return xs


def make_divisible(v: int, divisor: int = 8) -> int:
    """Round to the nearest multiple of ``divisor``, never below 90% of
    ``v`` (torchvision/mmcv ``_make_divisible``)."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class SqueezeExcite(nn.Module):
    """Global mean, Dense to make_divisible(C/4), ReLU, Dense to C, hard
    sigmoid gate."""

    def __init__(self, channels: int):
        super().__init__()
        self.fc1 = dense(channels, make_divisible(channels // 4))
        self.fc2 = dense(make_divisible(channels // 4), channels)

    def forward(self, x):
        s = F.relu(self.fc1(torch.mean(x, dim=(2, 3))))
        s = F.hardsigmoid(self.fc2(s))
        return x * s[:, :, None, None]


class InvertedResidualV3(nn.Module):
    """1x1 expand (when the width changes), depthwise k x k with the
    stride, optional squeeze-excite, 1x1 project; activation ReLU ('RE')
    or hard-swish ('HS'); residual at stride 1 with equal widths."""

    def __init__(self, in_ch: int, exp: int, out: int, kernel: int,
                 stride: int, se: bool, act: str):
        super().__init__()
        self.act = F.hardswish if act == "HS" else F.relu
        self.expanded = exp != in_ch
        if self.expanded:
            self.expand = conv(in_ch, exp, 1)
            self.expand_bn = BatchNorm(exp)
        self.dw = conv(exp, exp, kernel, stride, groups=exp,
                       padding=kernel // 2)
        self.dw_bn = BatchNorm(exp)
        self.se = SqueezeExcite(exp) if se else None
        self.project = conv(exp, out, 1)
        self.project_bn = BatchNorm(out)
        self.residual = stride == 1 and in_ch == out

    def forward(self, x):
        y = x
        if self.expanded:
            y = self.act(self.expand_bn(self.expand(y)))
        y = self.act(self.dw_bn(self.dw(y)))
        if self.se is not None:
            y = self.se(y)
        y = self.project_bn(self.project(y))
        return x + y if self.residual else y


# (kernel, expansion, out, SE, act, stride): the torchvision/mmseg tables
MNV3_LARGE = (
    (3, 16, 16, False, "RE", 1), (3, 64, 24, False, "RE", 2),
    (3, 72, 24, False, "RE", 1), (5, 72, 40, True, "RE", 2),
    (5, 120, 40, True, "RE", 1), (5, 120, 40, True, "RE", 1),
    (3, 240, 80, False, "HS", 2), (3, 200, 80, False, "HS", 1),
    (3, 184, 80, False, "HS", 1), (3, 184, 80, False, "HS", 1),
    (3, 480, 112, True, "HS", 1), (3, 672, 112, True, "HS", 1),
    (5, 672, 160, True, "HS", 2), (5, 960, 160, True, "HS", 1),
    (5, 960, 160, True, "HS", 1),
)
MNV3_SMALL = (
    (3, 16, 16, True, "RE", 2), (3, 72, 24, False, "RE", 2),
    (3, 88, 24, False, "RE", 1), (5, 96, 40, True, "HS", 2),
    (5, 240, 40, True, "HS", 1), (5, 240, 40, True, "HS", 1),
    (5, 120, 48, True, "HS", 1), (5, 144, 48, True, "HS", 1),
    (5, 288, 96, True, "HS", 2), (5, 576, 96, True, "HS", 1),
    (5, 576, 96, True, "HS", 1),
)


class MobileNetV3(nn.Module):
    """Stride-2 3x3 stem with hard-swish, then the block table; returns the
    outputs of the last stride-4 block, the last stride-8 block and the
    final block."""

    def __init__(self, arch: str = "large"):
        super().__init__()
        self.table = MNV3_LARGE if arch == "large" else MNV3_SMALL
        self.taps = (2, 5, 14) if arch == "large" else (0, 2, 10)
        self.stem = conv(3, 16, 3, 2, padding=1)
        self.stem_bn = BatchNorm(16)
        ch = 16
        for i, (k, e, o, se, act, s) in enumerate(self.table):
            self.add_module(f"block{i}",
                            InvertedResidualV3(ch, e, o, k, s, se, act))
            ch = o
        self.out_channels = [self.table[i][2] for i in self.taps]

    def forward(self, x) -> List[torch.Tensor]:
        x = F.hardswish(self.stem_bn(self.stem(x)))
        feats = []
        for i in range(len(self.table)):
            x = getattr(self, f"block{i}")(x)
            if i in self.taps:
                feats.append(x)
        return feats


class InvertedResidualV2(nn.Module):
    """Fast-SCNN's MobileNetV2 bottleneck: 1x1 expand (x ``expand``),
    depthwise 3x3 with the stride, 1x1 project, ReLU6 after the first
    two; residual at stride 1 with equal widths."""

    def __init__(self, in_ch: int, out: int, stride: int = 1,
                 expand: int = 6):
        super().__init__()
        hidden = in_ch * expand
        self.expand = conv(in_ch, hidden, 1)
        self.expand_bn = BatchNorm(hidden)
        self.dw = conv(hidden, hidden, 3, stride, groups=hidden, padding=1)
        self.dw_bn = BatchNorm(hidden)
        self.project = conv(hidden, out, 1)
        self.project_bn = BatchNorm(out)
        self.residual = stride == 1 and in_ch == out

    def forward(self, x):
        y = F.relu6(self.expand_bn(self.expand(x)))
        y = F.relu6(self.dw_bn(self.dw(y)))
        y = self.project_bn(self.project(y))
        return x + y if self.residual else y


class FastSCNN(nn.Module):
    """Fast-SCNN. Learning to downsample: a stride-2 3x3 ConvModule with
    mmcv's default padding 0, then two stride-2 depthwise-separable
    modules (``higher``, 1/8). Global feature extractor: three stages of
    three inverted residuals, a pyramid pooling module of
    ``global_block_channels[-1] // 4``-wide 1x1 ConvModules over adaptive
    pools, and a 1x1 fuse (``lower``, 1/32). Feature fusion: ``lower``
    resized to ``higher``, a 1x1 ConvModule and an activation-free 1x1,
    added to an activation-free 1x1 of ``higher``, ReLU (``fusion``).
    Returns ``[higher, lower, fusion]``."""

    def __init__(self, downsample_dw_channels: Tuple[int, int] = (32, 48),
                 higher_in_channels: int = 64, lower_in_channels: int = 128,
                 global_block_channels: Tuple[int, ...] = (64, 96, 128),
                 global_block_strides: Tuple[int, ...] = (2, 2, 1),
                 fusion_out_channels: int = 128,
                 pool_scales: Tuple[int, ...] = (1, 2, 3, 6)):
        super().__init__()
        dw, higher = downsample_dw_channels, higher_in_channels
        fusion = fusion_out_channels
        self.ltd_conv = ConvModule(3, dw[0], 3, stride=2, padding=0)
        self.ltd_ds1 = DepthwiseSeparableConvModule(dw[0], dw[1], 3, 2)
        self.ltd_ds2 = DepthwiseSeparableConvModule(dw[1], higher, 3, 2)
        ch = higher
        for s, (out, st) in enumerate(zip(global_block_channels,
                                          global_block_strides)):
            for b in range(3):
                self.add_module(f"gfe_{s}_{b}", InvertedResidualV2(
                    ch, out, st if b == 0 else 1))
                ch = out
        self.pool_scales = tuple(pool_scales)
        pool_ch = global_block_channels[-1] // 4
        for i in range(len(pool_scales)):
            self.add_module(f"ppm_{i}", ConvModule(ch, pool_ch, 1))
        self.gfe_out = ConvModule(ch + len(pool_scales) * pool_ch,
                                  lower_in_channels, 1)
        self.ffm_dwconv = ConvModule(lower_in_channels, fusion, 1)
        self.ffm_lower = ConvModule(fusion, fusion, 1, act=None)
        self.ffm_higher = ConvModule(higher, fusion, 1, act=None)
        self.n_stages = len(global_block_channels)
        self.out_channels = [higher, lower_in_channels, fusion]

    def forward(self, x) -> List[torch.Tensor]:
        higher = self.ltd_ds2(self.ltd_ds1(self.ltd_conv(x)))
        y = higher
        for s in range(self.n_stages):
            for b in range(3):
                y = getattr(self, f"gfe_{s}_{b}")(y)
        size = y.shape[2:]
        pools = [y] + [resize(getattr(self, f"ppm_{i}")(
            adaptive_avg_pool(y, sc)), size)
            for i, sc in enumerate(self.pool_scales)]
        lower = self.gfe_out(torch.cat(pools, dim=1))
        up = self.ffm_lower(self.ffm_dwconv(resize(lower, higher.shape[2:])))
        fusion = F.relu(self.ffm_higher(higher) + up)
        return [higher, lower, fusion]


class ChannelPReLU(nn.Module):
    """PReLU with one learnable negative slope per channel (init 0.25),
    kept under flax's leaf name ``alpha``."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x):
        return torch.where(x >= 0, x, self.alpha[:, None, None] * x)


class GlobalContextExtractor(nn.Module):
    """Squeeze-excite gate: global mean, Dense to ``channels //
    reduction``, ReLU, Dense back, sigmoid."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        mid = max(channels // reduction, 1)
        self.fc1 = dense(channels, mid)
        self.fc2 = dense(mid, channels)

    def forward(self, x):
        s = F.relu(self.fc1(torch.mean(x, dim=(2, 3))))
        return x * torch.sigmoid(self.fc2(s))[:, :, None, None]


class ContextGuidedBlock(nn.Module):
    """CGNet's block: a 1x1 conv (a stride-2 3x3 when downsampling) to
    ``n`` channels, BatchNorm, PReLU; a local depthwise 3x3 and a
    surrounding dilated depthwise 3x3, concatenated, BatchNorm, PReLU; a
    1x1 reduce when downsampling; the global-context gate; a residual when
    not downsampling and the widths agree."""

    def __init__(self, in_ch: int, out_channels: int, dilation: int = 2,
                 reduction: int = 16, downsample: bool = False):
        super().__init__()
        n = out_channels if downsample else out_channels // 2
        self.downsample = downsample
        self.conv1x1 = conv(in_ch, n, 3 if downsample else 1,
                            2 if downsample else 1,
                            padding=1 if downsample else 0)
        self.bn1 = BatchNorm(n)
        self.prelu1 = ChannelPReLU(n)
        self.floc = conv(n, n, 3, groups=n, padding=1)
        self.fsur = conv(n, n, 3, groups=n, dilation=dilation,
                         padding=dilation)
        self.bn2 = BatchNorm(2 * n)
        self.prelu2 = ChannelPReLU(2 * n)
        width = 2 * n
        if downsample:
            self.reduce = conv(2 * n, out_channels, 1)
            width = out_channels
        self.fglo = GlobalContextExtractor(width, reduction)
        self.residual = not downsample and in_ch == width

    def forward(self, x):
        y = self.prelu1(self.bn1(self.conv1x1(x)))
        joi = torch.cat([self.floc(y), self.fsur(y)], dim=1)
        joi = self.prelu2(self.bn2(joi))
        if self.downsample:
            joi = self.reduce(joi)
        out = self.fglo(joi)
        return x + out if self.residual else out


class CGNet(nn.Module):
    """CGNet (M3N21): a stem of three 3x3 convs (the first with stride 2)
    each with BatchNorm and PReLU, then two stages of context-guided
    blocks (a downsampling one, then ``num_blocks - 1``). The image is
    injected by 3x3 stride-2 average pools: once beside the stem's output
    and twice beside the first stage's. Each stage's output is
    concatenated (stage 0: [blocks, first block, image at 1/4]; stage 1:
    [first block, blocks]), then BatchNorm and PReLU. Returns the three
    concatenations, at strides 2, 4 and 8."""

    def __init__(self, num_channels: Tuple[int, int, int] = (32, 64, 128),
                 num_blocks: Tuple[int, int] = (3, 21),
                 dilations: Tuple[int, int] = (2, 4),
                 reductions: Tuple[int, int] = (8, 16)):
        super().__init__()
        c0 = num_channels[0]
        ch = 3
        for i in range(3):
            self.add_module(f"stem{i}", conv(ch, c0, 3, 2 if i == 0 else 1,
                                             padding=1))
            self.add_module(f"stem_bn{i}", BatchNorm(c0))
            self.add_module(f"stem_prelu{i}", ChannelPReLU(c0))
            ch = c0
        ch = c0 + 3
        self.cat_bn0 = BatchNorm(ch)
        self.cat_prelu0 = ChannelPReLU(ch)
        self.out_channels = [ch]
        self.num_blocks = tuple(num_blocks)
        for stage in range(2):
            c = num_channels[stage + 1]
            args = (dilations[stage], reductions[stage])
            self.add_module(f"stage{stage}_down", ContextGuidedBlock(
                ch, c, *args, downsample=True))
            for b in range(num_blocks[stage] - 1):
                self.add_module(f"stage{stage}_{b}",
                                ContextGuidedBlock(c, c, *args))
            ch = 2 * c + (3 if stage == 0 else 0)
            self.add_module(f"cat_bn{stage + 1}", BatchNorm(ch))
            self.add_module(f"cat_prelu{stage + 1}", ChannelPReLU(ch))
            self.out_channels.append(ch)

    def forward(self, x) -> List[torch.Tensor]:
        down1 = F.avg_pool2d(x, 3, 2, 1)
        y = x
        for i in range(3):
            y = getattr(self, f"stem_prelu{i}")(getattr(
                self, f"stem_bn{i}")(getattr(self, f"stem{i}")(y)))
        y = self.cat_prelu0(self.cat_bn0(torch.cat([y, down1], dim=1)))
        feats = [y]
        for stage in range(2):
            z = first = getattr(self, f"stage{stage}_down")(y)
            for b in range(self.num_blocks[stage] - 1):
                z = getattr(self, f"stage{stage}_{b}")(z)
            if stage == 0:
                z = torch.cat([z, first, F.avg_pool2d(down1, 3, 2, 1)],
                              dim=1)
            else:
                z = torch.cat([first, z], dim=1)
            y = getattr(self, f"cat_prelu{stage + 1}")(getattr(
                self, f"cat_bn{stage + 1}")(z))
            feats.append(y)
        return feats


class BasicConvBlock(nn.Module):
    """``num_convs`` 3x3 ConvModules; the first carries the stride, the
    rest the dilation."""

    def __init__(self, in_ch: int, features: int, num_convs: int = 2,
                 stride: int = 1, dilation: int = 1):
        super().__init__()
        self.num_convs = num_convs
        for i in range(num_convs):
            self.add_module(f"conv{i}", ConvModule(
                in_ch if i == 0 else features, features, 3,
                stride=stride if i == 0 else 1,
                dilation=1 if i == 0 else dilation))

    def forward(self, x):
        for i in range(self.num_convs):
            x = getattr(self, f"conv{i}")(x)
        return x


class DeconvModule(nn.Module):
    """ConvTranspose (kernel ``k``, stride ``scale``, output exactly
    ``scale`` times the input), BatchNorm, ReLU. The weight is kept in the
    (out, in, kh, kw) layout ``weights.from_flax`` gives the flax
    ConvTranspose kernel, which flax applies without flipping; the forward
    flips and transposes it for ``conv_transpose2d``."""

    def __init__(self, in_ch: int, features: int, kernel: int = 4,
                 scale: int = 2):
        super().__init__()
        if kernel < scale or (kernel - scale) % 2:
            raise ValueError("DeconvModule needs kernel >= scale and "
                             "kernel - scale even")
        self.deconv = conv(in_ch, features, kernel, bias=True, padding=0)
        self.scale = scale
        self.bn = BatchNorm(features)

    def forward(self, x):
        w = self.deconv.weight
        k = w.shape[-1]
        x = F.conv_transpose2d(x, w.flip(2, 3).transpose(0, 1),
                               self.deconv.bias, stride=self.scale,
                               padding=(k - self.scale) // 2)
        return F.relu(self.bn(x))


class InterpConv(nn.Module):
    """Bilinear 2x upsample and a 1x1 ConvModule (the conv first with
    ``conv_first``)."""

    def __init__(self, in_ch: int, features: int, conv_first: bool = False):
        super().__init__()
        self.conv = ConvModule(in_ch, features, 1)
        self.conv_first = conv_first

    def forward(self, x):
        def up(y):
            return resize(y, (y.shape[2] * 2, y.shape[3] * 2))
        if self.conv_first:
            return up(self.conv(x))
        return self.conv(up(x))


class UpConvBlock(nn.Module):
    """Upsample the coarse input (``InterpConv``, ``DeconvModule``, or a
    1x1 ConvModule when the paired stage never downsampled), concatenate
    the skip before it, then a BasicConvBlock."""

    def __init__(self, skip_ch: int, in_ch: int, features: int,
                 num_convs: int = 2, dilation: int = 1,
                 upsample: Optional[str] = "InterpConv"):
        super().__init__()
        if upsample == "InterpConv":
            self.upsample = InterpConv(in_ch, features)
        elif upsample == "DeconvModule":
            self.upsample = DeconvModule(in_ch, features)
        elif upsample is None:
            self.upsample = ConvModule(in_ch, features, 1)
        else:
            raise ValueError(upsample)
        self.conv_block = BasicConvBlock(skip_ch + features, features,
                                         num_convs, dilation=dilation)

    def forward(self, skip, x):
        return self.conv_block(torch.cat([skip, self.upsample(x)], dim=1))


class UNetBackbone(nn.Module):
    """mmseg's configurable UNet at its S5-D16 defaults: five encoder
    stages of two 3x3 ConvModules (width 64 x 2^i, 2x2 max pooling before
    stages 1-4) and four decoder stages. Returns ``[bottleneck, decoder
    outputs coarse to fine]``; the input's sides must divide by 16."""

    def __init__(self, base_channels: int = 64, num_stages: int = 5,
                 strides: Sequence[int] = (1, 1, 1, 1, 1),
                 enc_num_convs: Sequence[int] = (2, 2, 2, 2, 2),
                 dec_num_convs: Sequence[int] = (2, 2, 2, 2),
                 downsamples: Sequence[bool] = (True, True, True, True),
                 enc_dilations: Sequence[int] = (1, 1, 1, 1, 1),
                 dec_dilations: Sequence[int] = (1, 1, 1, 1),
                 upsample: Optional[str] = "InterpConv"):
        super().__init__()
        self.num_stages = ns = num_stages
        self.strides, self.downsamples = tuple(strides), tuple(downsamples)
        self.rate = 1
        for i in range(1, ns):
            if strides[i] == 2 or downsamples[i - 1]:
                self.rate *= 2
        ch = 3
        for i in range(ns):
            out = base_channels * 2 ** i
            self.add_module(f"enc{i}", BasicConvBlock(
                ch, out, enc_num_convs[i], stride=strides[i],
                dilation=enc_dilations[i]))
            ch = out
        self.out_channels = [ch]
        for i in reversed(range(ns - 1)):
            up = upsample if (strides[i + 1] != 1 or downsamples[i]) else None
            out = base_channels * 2 ** i
            self.add_module(f"dec{i}", UpConvBlock(
                out, ch, out, dec_num_convs[i], dec_dilations[i], up))
            ch = out
            self.out_channels.append(ch)

    def forward(self, x) -> List[torch.Tensor]:
        if x.shape[2] % self.rate or x.shape[3] % self.rate:
            raise ValueError(f"input {tuple(x.shape[2:])} not divisible by "
                             f"the downsample rate {self.rate}")
        enc_outs = []
        for i in range(self.num_stages):
            if i and self.strides[i] == 1 and self.downsamples[i - 1]:
                x = F.max_pool2d(x, 2, 2)
            x = getattr(self, f"enc{i}")(x)
            enc_outs.append(x)
        dec_outs = [x]
        for i in reversed(range(self.num_stages - 1)):
            x = getattr(self, f"dec{i}")(enc_outs[i], x)
            dec_outs.append(x)
        return dec_outs
