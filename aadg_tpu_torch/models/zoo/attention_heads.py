"""The object-contextual head (port of ``SelfAttentionBlock`` and
``OCRHead`` from ``aadg_tpu/models/zoo/attention_heads.py``), NCHW inside.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch
from torch import nn

from ..mobilenetv2 import conv
from .heads import DROPOUT, ClsSeg
from .layers import ConvModule, input_channels, resize, transform_inputs


def _project(block: nn.Module, name: str, in_ch: int, features: int,
             num_convs: int, use_conv_module: bool,
             zero_init: bool = False) -> List[str]:
    """Add ``<name>_0`` ... to ``block``: ConvModules (conv, BatchNorm and
    ReLU on every conv) or plain biased 1x1 convs, zero-initialized with
    ``zero_init``; returns their names."""
    names = []
    for i in range(num_convs):
        ch = in_ch if i == 0 else features
        if use_conv_module:
            m = ConvModule(ch, features, 1)
        else:
            m = conv(ch, features, 1, bias=True)
            if zero_init:
                nn.init.zeros_(m.weight)
        block.add_module(f"{name}_{i}", m)
        names.append(f"{name}_{i}")
    return names


class SelfAttentionBlock(nn.Module):
    """Query/key/value projections of ``channels``, softmax attention of
    the query pixels over the key positions (scaled by channels^-0.5 with
    ``matmul_norm``), then an out projection to ``out_channels``
    (``with_out``; else the value projects straight to ``out_channels``).
    mmseg's parameterization: ``*_norm`` projections are ConvModules, the
    others plain convs, and a plain out projection starts at zero."""

    def __init__(self, key_in_ch: int, query_in_ch: int, channels: int,
                 out_channels: int, key_query_num_convs: int = 2,
                 value_out_num_convs: int = 1, key_query_norm: bool = True,
                 value_out_norm: bool = True, matmul_norm: bool = True,
                 with_out: bool = True):
        super().__init__()
        self.channels, self.matmul_norm = channels, matmul_norm
        self.key_mods = _project(self, "key_project", key_in_ch, channels,
                                 key_query_num_convs, key_query_norm)
        self.query_mods = _project(self, "query_project", query_in_ch,
                                   channels, key_query_num_convs,
                                   key_query_norm)
        self.value_mods = _project(
            self, "value_project", key_in_ch,
            channels if with_out else out_channels, value_out_num_convs,
            value_out_norm)
        self.out_mods = (_project(self, "out_project", channels,
                                  out_channels, value_out_num_convs,
                                  value_out_norm, zero_init=True)
                         if with_out else [])

    def _project_all(self, names, x):
        for n in names:
            x = getattr(self, n)(x)
        return x

    def forward(self, query_feats, key_feats):
        b, _, h, w = query_feats.shape
        q = self._project_all(self.query_mods, query_feats).flatten(2)
        k = self._project_all(self.key_mods, key_feats).flatten(2)
        v = self._project_all(self.value_mods, key_feats).flatten(2)
        sim = torch.matmul(q.transpose(1, 2), k)          # (b, hw, keys)
        if self.matmul_norm:
            sim = sim * (self.channels ** -0.5)
        ctx = torch.matmul(torch.softmax(sim, dim=-1), v.transpose(1, 2))
        ctx = ctx.transpose(1, 2).reshape(b, -1, h, w)
        return self._project_all(self.out_mods, ctx)


class OCRHead(nn.Module):
    """Object-contextual representations, a cascade head called as
    ``head(feats, prev_logits, mask)``: a 3x3 bottleneck, soft object
    regions from the previous head's logits (softmax over the pixels)
    pooling the pixel features into one context per class, the pixels
    attending over those contexts, a 1x1 ConvModule over the attended
    features and the bottleneck's, then ClsSeg."""

    def __init__(self, in_channels: Sequence[int], num_classes: int,
                 channels: int = 512, ocr_channels: int = 256,
                 scale: float = 1.0, in_index: Any = -1,
                 input_transform: Optional[str] = None,
                 dropout_ratio: float = DROPOUT):
        super().__init__()
        self.in_index, self.input_transform = in_index, input_transform
        self.scale = scale
        in_ch = input_channels(in_channels, in_index, input_transform)
        self.bottleneck = ConvModule(in_ch, channels, 3)
        self.object_attention = SelfAttentionBlock(
            channels, channels, ocr_channels, channels,
            key_query_num_convs=2, matmul_norm=True)
        self.oab_bottleneck = ConvModule(2 * channels, channels, 1)
        self.cls = ClsSeg(channels, num_classes, dropout_ratio)

    def forward(self, inputs, prev_output, mask=None):
        x = transform_inputs(inputs, self.in_index, self.input_transform)
        feats = self.bottleneck(x)
        b, c, h, w = feats.shape
        prev = resize(prev_output, (h, w))
        probs = torch.softmax(self.scale * prev.flatten(2), dim=-1)
        # one context per class, as a (b, c, 1, classes) pseudo-image
        context = torch.matmul(probs, feats.flatten(2).transpose(1, 2))
        context = context.transpose(1, 2)[:, :, None]
        attended = self.object_attention(feats, context)
        out = self.oab_bottleneck(torch.cat([attended, feats], dim=1))
        return self.cls(out, mask)
