"""Shared building blocks of the zoo (port of
``aadg_tpu/models/zoo/layers.py``), NCHW inside the models.

``resize`` is mmseg's bilinear resize with ``align_corners=False``: half-pixel
centres, source coordinates clamped to the edge and no antialiasing when
downscaling. As in the JAX package, a resize that shrinks either side goes
through ``bilinear_resize``, two products with interpolation matrices whose
weights are computed in float64 (``F.interpolate`` computes the source
coordinates in f32, 4.5e-6 away on a 16 -> 7 downscale), and an upscale
through ``F.interpolate``, which equals ``jax.image.resize`` there.
"""

from __future__ import annotations

import functools
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from ..mobilenetv2 import BatchNorm, conv


@functools.lru_cache(maxsize=None)
def _interp_matrix(n_in: int, n_out: int, align_corners: bool) -> np.ndarray:
    """(n_out, n_in) bilinear interpolation weights with torch
    ``F.interpolate`` semantics and no antialiasing: half-pixel centres, or
    endpoint-pinned source coordinates with ``align_corners``."""
    if n_out == n_in:
        return np.eye(n_out, dtype=np.float32)
    if align_corners and n_out > 1:
        src = np.linspace(0.0, n_in - 1.0, n_out)
    else:
        src = np.clip((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5,
                      0.0, n_in - 1.0)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    frac = (src - lo).astype(np.float32)
    m = np.zeros((n_out, n_in), np.float32)
    m[np.arange(n_out), lo] += 1.0 - frac
    m[np.arange(n_out), hi] += frac
    return m


# (n_in, n_out, align_corners, device, dtype) -> the matrix on the device,
# copied there once, so a warmed step makes no host-to-device copy
_MATRICES: dict = {}


def _matrix(n_in, n_out, align_corners, like: torch.Tensor) -> torch.Tensor:
    key = (n_in, n_out, align_corners, like.device, like.dtype)
    if key not in _MATRICES:
        _MATRICES[key] = torch.from_numpy(
            _interp_matrix(n_in, n_out, align_corners)).to(like)
    return _MATRICES[key]


def bilinear_resize(x: torch.Tensor, size: Tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of NCHW ``x`` to ``size`` as two separable products
    with ``_interp_matrix`` (the JAX package's form, exact in both
    directions)."""
    h, w = int(size[0]), int(size[1])
    if tuple(x.shape[2:]) == (h, w):
        return x
    y = torch.einsum("oh,nchw->ncow",
                     _matrix(x.shape[2], h, align_corners, x), x)
    return torch.einsum("pw,ncow->ncop",
                        _matrix(x.shape[3], w, align_corners, x), y)


def resize(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with ``align_corners=False``, up or down."""
    h, w = int(size[0]), int(size[1])
    if tuple(x.shape[2:]) == (h, w):
        return x
    if h < x.shape[2] or w < x.shape[3]:
        return bilinear_resize(x, (h, w))
    return F.interpolate(x, size=(h, w), mode="bilinear",
                         align_corners=False)


class ConvModule(nn.Module):
    """mmcv ConvModule: conv -> BatchNorm -> activation (``relu``,
    ``sigmoid`` or None). ``padding`` None is 'same' for the dilation; the
    conv has a bias only without the norm unless ``bias`` says otherwise."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: int = 1, dilation: int = 1, norm: bool = True,
                 act: Optional[str] = "relu", bias: Optional[bool] = None,
                 padding: Optional[int] = None):
        super().__init__()
        if act not in ("relu", "sigmoid", None):
            raise ValueError(act)
        pad = dilation * (kernel - 1) // 2 if padding is None else padding
        self.conv = conv(in_ch, features, kernel, stride, dilation=dilation,
                         bias=(not norm) if bias is None else bias,
                         padding=pad)
        self.bn = BatchNorm(features) if norm else None
        self.act = act

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.act == "relu":
            return F.relu(x)
        if self.act == "sigmoid":
            return torch.sigmoid(x)
        return x


class DepthwiseSeparableConvModule(nn.Module):
    """mmcv DepthwiseSeparableConvModule: a depthwise k x k conv (carrying
    the stride and dilation) with BatchNorm and ReLU, then a pointwise 1x1
    conv with BatchNorm and ReLU; no biases."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: int = 1, dilation: int = 1):
        super().__init__()
        self.depthwise = conv(in_ch, in_ch, kernel, stride, groups=in_ch,
                              dilation=dilation,
                              padding=dilation * (kernel - 1) // 2)
        self.dw_bn = BatchNorm(in_ch)
        self.pointwise = conv(in_ch, features, 1)
        self.pw_bn = BatchNorm(features)

    def forward(self, x):
        x = F.relu(self.dw_bn(self.depthwise(x)))
        return F.relu(self.pw_bn(self.pointwise(x)))


def adaptive_avg_pool(x: torch.Tensor, out) -> torch.Tensor:
    """torch AdaptiveAvgPool2d: bin i of an axis of n covers
    [floor(i n / o), ceil((i + 1) n / o)), the JAX package's binning."""
    return F.adaptive_avg_pool2d(x, out)


def transform_inputs(inputs: Sequence[torch.Tensor], in_index: Any,
                     input_transform: Optional[str]):
    """BaseDecodeHead._transform_inputs: one stage, several stages, or the
    selected stages resized to the first one's size and concatenated."""
    if input_transform == "resize_concat":
        xs = [inputs[i] for i in in_index]
        size = xs[0].shape[2:]
        return torch.cat([resize(x, size) for x in xs], dim=1)
    if input_transform == "multiple_select":
        return [inputs[i] for i in in_index]
    if isinstance(inputs, (list, tuple)):
        return inputs[in_index]
    return inputs


def input_channels(channels: Sequence[int], in_index: Any,
                   input_transform: Optional[str]) -> int:
    """The width ``transform_inputs`` hands a head from stages of
    ``channels``."""
    if input_transform == "resize_concat":
        return sum(channels[i] for i in in_index)
    return channels[in_index]
