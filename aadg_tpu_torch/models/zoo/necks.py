"""The FPN neck (port of ``aadg_tpu/models/zoo/necks.py``), NCHW inside:
biased 1x1 laterals, a nearest-neighbour top-down pathway, biased 3x3
output convs, and extra levels by stride-2 subsampling of the last."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from ..mobilenetv2 import conv


def nearest_resize(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """torch ``F.interpolate(mode='nearest')``'s rule as the JAX package
    writes it: output row i reads input row ``floor(i * (in / out))``,
    the product taken in f32."""
    h, w = int(size[0]), int(size[1])
    ys = torch.floor(torch.arange(h, device=x.device, dtype=torch.float32)
                     * (x.shape[2] / h)).long()
    xs = torch.floor(torch.arange(w, device=x.device, dtype=torch.float32)
                     * (x.shape[3] / w)).long()
    return x[:, :, ys][:, :, :, xs]


class FPN(nn.Module):
    """mmseg's FPN without norms or activations; ``num_outs`` outputs of
    ``out_channels``, the ones past the backbone's stages taken by a 1x1
    max pool of stride 2 from the previous output."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_outs: int = 4):
        super().__init__()
        self.n_in = len(in_channels)
        self.num_outs = num_outs
        for i, c in enumerate(in_channels):
            self.add_module(f"lateral_{i}", conv(c, out_channels, 1,
                                                 bias=True))
            self.add_module(f"fpn_conv_{i}", conv(out_channels, out_channels,
                                                  3, bias=True, padding=1))
        self.out_channels = [out_channels] * max(num_outs, self.n_in)

    def forward(self, inputs):
        laterals = [getattr(self, f"lateral_{i}")(x)
                    for i, x in enumerate(inputs)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + nearest_resize(
                laterals[i], laterals[i - 1].shape[2:])
        outs = [getattr(self, f"fpn_conv_{i}")(lat)
                for i, lat in enumerate(laterals)]
        while len(outs) < self.num_outs:
            outs.append(F.max_pool2d(outs[-1], 1, 2))
        return outs
