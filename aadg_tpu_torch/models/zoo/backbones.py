"""Zoo backbones (port of ``aadg_tpu/models/zoo/backbones.py`` except
ResNeSt, FastSCNN and CGNet), NCHW inside. Each returns a list of features
and names its widths in ``out_channels``:

- ``ResNetV1c`` (50, 101): deep 3x3 stem, dilations (1, 1, 2, 4), output
  stride 8; four stages. ``ResNeXt`` is the same network with grouped
  3x3 convolutions (32 groups of 4 channels per 64 planes).
- ``HRNet`` (W18, W32, W48): four parallel branches at strides 4/8/16/32
  with full cross-resolution fusion.
- ``MobileNetV3`` ('large'/'small'): inverted residuals with
  squeeze-excite and hard-swish; the three taps the LRASPP head reads.
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
from .layers import ConvModule, resize


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


class ResNetV1c(nn.Module):
    """mmseg's default encoder: stem of three 3x3 convs (the first with
    stride 2) and a 3x3 max pool, then stages of (3, 4, 6, 3) bottlenecks
    with strides (1, 2, 1, 1) and dilations (1, 1, 2, 4); (3, 4, 23, 3)
    bottlenecks at depth 101."""

    blocks = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}

    def __init__(self, depth: int = 50, groups: int = 1,
                 base_width: int = 64,
                 dilations: Tuple[int, ...] = (1, 1, 2, 4),
                 strides: Tuple[int, ...] = (1, 2, 1, 1)):
        super().__init__()
        ch = 3
        for i, out in enumerate((32, 32, 64)):
            self.add_module(f"stem{i}", conv(ch, out, 3, 2 if i == 0 else 1,
                                             padding=1))
            self.add_module(f"stem_bn{i}", BatchNorm(out))
            ch = out
        self.stage_blocks = self.blocks[depth]
        self.out_channels = []
        for s, n in enumerate(self.stage_blocks):
            planes = 64 * 2 ** s
            for b in range(n):
                self.add_module(f"layer{s + 1}_{b}", Bottleneck(
                    ch, planes, strides[s] if b == 0 else 1, dilations[s],
                    groups, base_width))
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


def ResNeXt(depth: int = 50, groups: int = 32,
            base_width: int = 4) -> ResNetV1c:
    """ResNeXt (32x4d): ResNetV1c with grouped bottlenecks."""
    return ResNetV1c(depth, groups, base_width)


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
