"""DeepLabV3+ with the MobileNetV2 encoder (port of
``aadg_tpu/models/deeplab.py``).

``model(x) -> (logits, feature)``: NHWC images in, NHWC logits at the input
resolution and the pooled 1280-d encoder feature out (the discriminator's
input). ASPP rates (12, 24, 36) plus the image-pooling branch, separable
3x3 convs, decoder on the 1/4 low-level feature, 3x3 segmentation head and
x4 bilinear upsampling (``F.interpolate``, half-pixel centres, which equals
``jax.image.resize(..., "bilinear")`` when upsampling). Under autocast the
segmentation head runs in f32, as the JAX model's does. ``remat``
(``TPU.REMAT``) checkpoints every inverted residual of the encoder.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from .mobilenetv2 import BatchNorm, MobileNetV2Encoder, conv


class SeparableConvBNReLU(nn.Module):
    def __init__(self, in_ch: int, features: int, dilation: int = 1):
        super().__init__()
        self.Conv_0 = conv(in_ch, in_ch, 3, groups=in_ch, dilation=dilation)
        self.Conv_1 = conv(in_ch, features, 1)
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.Conv_1(self.Conv_0(x))))


class ASPP(nn.Module):
    def __init__(self, in_ch: int, features: int = 256,
                 atrous_rates=(12, 24, 36)):
        super().__init__()
        self.Conv_0 = conv(in_ch, features, 1)
        self.BatchNorm_0 = BatchNorm(features)
        self.rates = len(atrous_rates)
        for i, rate in enumerate(atrous_rates):
            self.add_module(f"SeparableConvBNReLU_{i}",
                            SeparableConvBNReLU(in_ch, features, rate))
        self.Conv_1 = conv(in_ch, features, 1)
        self.BatchNorm_1 = BatchNorm(features)
        self.Conv_2 = conv(features * (2 + self.rates), features, 1)
        self.BatchNorm_2 = BatchNorm(features)
        self.add_module(f"SeparableConvBNReLU_{self.rates}",
                        SeparableConvBNReLU(features, features))

    def forward(self, x):
        branches = [F.relu(self.BatchNorm_0(self.Conv_0(x)))]
        for i in range(self.rates):
            branches.append(getattr(self, f"SeparableConvBNReLU_{i}")(x))
        pooled = torch.mean(x, dim=(2, 3), keepdim=True)
        pooled = F.relu(self.BatchNorm_1(self.Conv_1(pooled)))
        branches.append(pooled.expand(-1, -1, x.shape[2], x.shape[3]))
        y = torch.cat(branches, dim=1)
        y = F.relu(self.BatchNorm_2(self.Conv_2(y)))
        return getattr(self, f"SeparableConvBNReLU_{self.rates}")(y)


class DeepLabV3Plus(nn.Module):
    feature_dim = 1280

    def __init__(self, num_classes: int, decoder_channels: int = 256,
                 remat: bool = False):
        super().__init__()
        self.encoder = MobileNetV2Encoder(remat=remat)
        self.aspp = ASPP(1280, decoder_channels)
        self.low_conv = conv(24, 48, 1)
        self.BatchNorm_0 = BatchNorm(48)
        self.SeparableConvBNReLU_0 = SeparableConvBNReLU(
            decoder_channels + 48, decoder_channels)
        self.SeparableConvBNReLU_1 = SeparableConvBNReLU(
            decoder_channels, decoder_channels)
        self.seg_head = conv(decoder_channels, num_classes, 3, bias=True)

    def forward(self, x: torch.Tensor):
        """x: (N, H, W, 3) -> logits (N, H, W, classes) f32, feature
        (N, 1280) f32."""
        h, w = x.shape[1], x.shape[2]
        low, high = self.encoder(x.permute(0, 3, 1, 2))
        y = self.aspp(high)
        y = F.interpolate(y, size=low.shape[2:], mode="bilinear",
                          align_corners=False)
        skip = F.relu(self.BatchNorm_0(self.low_conv(low)))
        y = torch.cat([y, skip.to(y.dtype)], dim=1)
        y = self.SeparableConvBNReLU_1(self.SeparableConvBNReLU_0(y))
        with torch.autocast(device_type=x.device.type, enabled=False):
            logits = self.seg_head(y.to(self.seg_head.weight.dtype))
            logits = F.interpolate(logits, size=(h, w), mode="bilinear",
                                   align_corners=False)
        feature = torch.mean(high, dim=(2, 3))
        dtype = self.seg_head.weight.dtype
        return logits.permute(0, 2, 3, 1).to(dtype), feature.to(dtype)
