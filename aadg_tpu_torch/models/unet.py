"""U-Net (port of ``aadg_tpu/models/unet.py``).

Six ``ConvBlock``s down (two 3x3 conv + BatchNorm + ReLU each, 2x2 max
pooling between them) and five up (bilinear upsampling to the skip's size,
concatenation, ``ConvBlock``), then a 1x1 convolution with bias.
``model(x) -> (logits, feature)``: NHWC images in, NHWC logits at the input
resolution and the bottleneck's spatial mean (N, 512) out, the
discriminator's input. Submodules carry the flax module names
(``ConvBlock_0`` ... ``ConvBlock_10``, ``Conv_0``) for ``weights.from_flax``.

The JAX model has no compute dtype: it runs in f32, so this one runs with
autocast off. Bilinear upsampling is ``F.interpolate`` with half-pixel
centres, which equals ``jax.image.resize(..., "bilinear")`` when
upsampling.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from .mobilenetv2 import BatchNorm, conv


class ConvBlock(nn.Module):
    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.Conv_0 = conv(in_ch, features, 3)
        self.BatchNorm_0 = BatchNorm(features)
        self.Conv_1 = conv(features, features, 3)
        self.BatchNorm_1 = BatchNorm(features)

    def forward(self, x):
        x = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        return F.relu(self.BatchNorm_1(self.Conv_1(x)))


class UNet(nn.Module):
    """The JAX model at its factory's width (``base`` 32)."""

    base = 32
    feature_dim = base * 16

    def __init__(self, in_channels: int = 3, out_channels: int = 1):
        super().__init__()
        c = self.base
        down = [c, c * 2, c * 4, c * 8, c * 16, c * 16]
        up = [c * 16, c * 8, c * 4, c * 2, c]
        ch = in_channels
        for i, f in enumerate(down):
            self.add_module(f"ConvBlock_{i}", ConvBlock(ch, f))
            ch = f
        # up block j joins the upsampled input (ch) with skip 4 - j
        for j, f in enumerate(up):
            self.add_module(f"ConvBlock_{len(down) + j}",
                            ConvBlock(ch + down[4 - j], f))
            ch = f
        self.Conv_0 = conv(ch, out_channels, 1, bias=True)

    def forward(self, x: torch.Tensor):
        """x: (N, H, W, in_channels) -> logits (N, H, W, out_channels),
        feature (N, 512), both f32."""
        with torch.autocast(device_type=x.device.type, enabled=False):
            y = x.float().permute(0, 3, 1, 2)
            skips = []
            for i in range(6):
                if i:
                    y = F.max_pool2d(y, 2, 2)
                y = getattr(self, f"ConvBlock_{i}")(y)
                skips.append(y)
            feature = torch.mean(y, dim=(2, 3))
            for j in range(5):
                skip = skips[4 - j]
                y = F.interpolate(y, size=skip.shape[2:], mode="bilinear",
                                  align_corners=False)
                y = getattr(self, f"ConvBlock_{6 + j}")(torch.cat([y, skip],
                                                                  dim=1))
            logits = self.Conv_0(y)
        return logits.permute(0, 2, 3, 1), feature
