"""Decode heads of the attention/context family (port of
``aadg_tpu/models/zoo/attention_heads.py``), NCHW inside: the shared
``SelfAttentionBlock``; the FCN-with-context-block heads non-local
(``NLHead``), global context (``GCHead``), disentangled non-local
(``DNLHead``) and criss-cross (``CCHead``); ANN, APC, DM, EMA, DA, PSA and
Enc heads; and the object-contextual cascade head ``OCRHead``.

Heads whose parameters get no gradient in the train forward, as in the JAX
package: EMAHead's ``ema_mid_conv`` (the EM iterations and the
reconstruction are detached), DAHead's ``pam_cls``/``cam_cls`` (their
logits feed only the auxiliary losses of the reference's ``forward_train``)
and EncHead's ``se_layer`` (likewise). They are built, so every flax leaf
has its tensor, and not run; the optimizer steps them with a zero gradient
(``engine/state.py::ScheduledAdam``).
"""

from __future__ import annotations

import functools
import math
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from ..mobilenetv2 import BatchNorm, conv
from ..segformer import dense
from .heads import DROPOUT, ClsSeg, Dropout
from .layers import (ConvModule, adaptive_avg_pool, bilinear_resize,
                     input_channels, resize, transform_inputs)


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """(b, c, h, w) -> (b, h*w, c), positions in row-major order."""
    return x.flatten(2).transpose(1, 2)


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
    others plain convs, and a plain out projection starts at zero.
    ``share_key_query``: the query goes through the key's projection.
    ``key_pool_scales``: the keys and values are the concatenated tokens
    of their adaptive average pools at those scales (ANN's pyramid)."""

    def __init__(self, key_in_ch: int, query_in_ch: int, channels: int,
                 out_channels: int, key_query_num_convs: int = 2,
                 value_out_num_convs: int = 1, key_query_norm: bool = True,
                 value_out_norm: bool = True, matmul_norm: bool = True,
                 with_out: bool = True, share_key_query: bool = False,
                 key_pool_scales: Optional[Tuple[int, ...]] = None):
        super().__init__()
        self.channels, self.matmul_norm = channels, matmul_norm
        self.key_pool_scales = key_pool_scales
        self.key_mods = _project(self, "key_project", key_in_ch, channels,
                                 key_query_num_convs, key_query_norm)
        self.query_mods = (self.key_mods if share_key_query else _project(
            self, "query_project", query_in_ch, channels,
            key_query_num_convs, key_query_norm))
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

    def _pyramid(self, x):
        """(b, c, h, w) -> (b, c, tokens)."""
        if self.key_pool_scales is None:
            return x.flatten(2)
        return torch.cat([adaptive_avg_pool(x, s).flatten(2)
                          for s in self.key_pool_scales], dim=2)

    def forward(self, query_feats, key_feats):
        b, _, h, w = query_feats.shape
        q = self._project_all(self.query_mods, query_feats).flatten(2)
        k = self._pyramid(self._project_all(self.key_mods, key_feats))
        v = self._pyramid(self._project_all(self.value_mods, key_feats))
        sim = torch.matmul(q.transpose(1, 2), k)          # (b, hw, keys)
        if self.matmul_norm:
            sim = sim * (self.channels ** -0.5)
        ctx = torch.matmul(torch.softmax(sim, dim=-1), v.transpose(1, 2))
        ctx = ctx.transpose(1, 2).reshape(b, -1, h, w)
        return self._project_all(self.out_mods, ctx)


# -- FCN with a context block: NL / GC / DNL / CC ----------------------------

class _FCNContextHead(nn.Module):
    """A 3x3 ConvModule, the head's context block, a second 3x3
    ConvModule, the ``conv_cat`` over the input and that output, ClsSeg."""

    def __init__(self, in_channels: Sequence[int], num_classes: int,
                 channels: int = 256, in_index: Any = -1,
                 input_transform: Optional[str] = None,
                 dropout_ratio: float = DROPOUT, concat_input: bool = True):
        super().__init__()
        self.in_index, self.input_transform = in_index, input_transform
        self.concat_input = concat_input
        in_ch = input_channels(in_channels, in_index, input_transform)
        self.convs_0 = ConvModule(in_ch, channels, 3)
        self.convs_1 = ConvModule(channels, channels, 3)
        if concat_input:
            self.conv_cat = ConvModule(in_ch + channels, channels, 3)
        self.cls = ClsSeg(channels, num_classes, dropout_ratio)

    def context_block(self, x):
        raise NotImplementedError

    def forward(self, inputs, mask=None):
        x = transform_inputs(inputs, self.in_index, self.input_transform)
        y = self.convs_1(self.context_block(self.convs_0(x)))
        if self.concat_input:
            y = self.conv_cat(torch.cat([x, y], dim=1))
        return self.cls(y, mask)


class NLHead(_FCNContextHead):
    """Embedded-Gaussian non-local block (reduction 2, scaled similarity)
    with a BatchNorm'd 1x1 output projection added to its input."""

    def __init__(self, in_channels, num_classes, channels: int = 256,
                 reduction: int = 2, use_scale: bool = True, **kw):
        super().__init__(in_channels, num_classes, channels, **kw)
        inter = max(channels // reduction, 1)
        self.inter, self.use_scale = inter, use_scale
        for n in ("theta", "phi", "g"):
            self.add_module(n, conv(channels, inter, 1, bias=True))
        self.conv_out = ConvModule(inter, channels, 1, act=None)

    def context_block(self, x):
        b, _, h, w = x.shape
        theta, phi, g = (_tokens(getattr(self, n)(x))
                         for n in ("theta", "phi", "g"))
        sim = torch.matmul(theta, phi.transpose(1, 2))
        if self.use_scale:
            sim = sim * (self.inter ** -0.5)
        y = torch.matmul(torch.softmax(sim, dim=-1), g)
        y = y.transpose(1, 2).reshape(b, self.inter, h, w)
        return x + self.conv_out(y)


class GCHead(_FCNContextHead):
    """GCNet's context block: softmax attention pooling to one context
    vector, a channel-add bottleneck (1x1 conv to ``ratio`` C, LayerNorm,
    ReLU, 1x1 conv) added to every position."""

    def __init__(self, in_channels, num_classes, channels: int = 256,
                 ratio: float = 0.25, **kw):
        super().__init__(in_channels, num_classes, channels, **kw)
        mid = int(channels * ratio)
        self.conv_mask = conv(channels, 1, 1, bias=True)
        self.channel_add_0 = conv(channels, mid, 1, bias=True)
        self.channel_add_ln = nn.LayerNorm(mid, eps=1e-5)
        self.channel_add_1 = conv(mid, channels, 1, bias=True)

    def context_block(self, x):
        mask = torch.softmax(self.conv_mask(x).flatten(1), dim=-1)  # (b, n)
        ctx = torch.matmul(x.flatten(2), mask[:, :, None])           # (b,c,1)
        t = self.channel_add_0(ctx[..., None])                       # (b,m,1,1)
        t = F.relu(self.channel_add_ln(t.flatten(1)))
        return x + self.channel_add_1(t[:, :, None, None])


class DNLHead(_FCNContextHead):
    """Disentangled non-local: a whitened pairwise term (mean-subtracted
    queries and keys, scaled, softmax at ``temperature``) plus a unary
    term (softmax of a 1x1 mask), both attending over g; the BatchNorm'd
    projection is added to the input."""

    def __init__(self, in_channels, num_classes, channels: int = 256,
                 reduction: int = 2, temperature: float = 0.05, **kw):
        super().__init__(in_channels, num_classes, channels, **kw)
        inter = max(channels // reduction, 1)
        self.inter, self.temperature = inter, temperature
        for n in ("theta", "phi", "g"):
            self.add_module(n, conv(channels, inter, 1, bias=True))
        self.conv_mask = conv(channels, 1, 1, bias=True)
        self.conv_out = ConvModule(inter, channels, 1, act=None)

    def context_block(self, x):
        b, _, h, w = x.shape
        theta, phi, g = (_tokens(getattr(self, n)(x))
                         for n in ("theta", "phi", "g"))
        theta = theta - theta.mean(dim=1, keepdim=True)
        phi = phi - phi.mean(dim=1, keepdim=True)
        sim = torch.matmul(theta, phi.transpose(1, 2)) * (self.inter ** -0.5)
        y = torch.matmul(torch.softmax(sim / self.temperature, dim=-1), g)
        unary = torch.softmax(self.conv_mask(x).flatten(1), dim=-1)
        y = y + torch.matmul(unary[:, None], g)                 # (b, 1, c)
        y = y.transpose(1, 2).reshape(b, self.inter, h, w)
        return x + self.conv_out(y)


class CrissCrossAttention(nn.Module):
    """Each position attends over its column and its row (its own position
    counted once, in the row) with one joint softmax; the result is added
    to the input scaled by ``gamma`` (initialized at 0)."""

    def __init__(self, channels: int):
        super().__init__()
        inter = max(channels // 8, 1)
        self.query = conv(channels, inter, 1, bias=True)
        self.key = conv(channels, inter, 1, bias=True)
        self.value = conv(channels, channels, 1, bias=True)
        self.gamma = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        q, k, v = self.query(x), self.key(x), self.value(x)
        h = x.shape[2]
        e_col = torch.einsum("bchw,bcHw->bhwH", q, k)
        eye = torch.eye(h, dtype=x.dtype, device=x.device)[None, :, None, :]
        e_col = e_col - 1e9 * eye
        e_row = torch.einsum("bchw,bchW->bhwW", q, k)
        attn = torch.softmax(torch.cat([e_col, e_row], dim=-1), dim=-1)
        out = (torch.einsum("bhwH,bcHw->bchw", attn[..., :h], v)
               + torch.einsum("bhwW,bchW->bchw", attn[..., h:], v))
        return x + self.gamma * out


class CCHead(_FCNContextHead):
    """CCNet's head: the same criss-cross attention applied
    ``recurrence`` times."""

    def __init__(self, in_channels, num_classes, channels: int = 256,
                 recurrence: int = 2, **kw):
        super().__init__(in_channels, num_classes, channels, **kw)
        self.recurrence = recurrence
        self.cca = CrissCrossAttention(channels)

    def context_block(self, x):
        for _ in range(self.recurrence):
            x = self.cca(x)
        return x


# -- ANN / APC / DM / EMA ------------------------------------------------------

class ANNHead(nn.Module):
    """Asymmetric non-local: AFNB (queries from the high stage, pyramid
    keys and values from the low one; concatenated with the high stage
    and fused by a BatchNorm'd 1x1), dropout, a 3x3 bottleneck, APNB (the
    same block on its own output with the key projection shared by the
    query, concatenated and fused by a 1x1 ConvModule), ClsSeg. Two
    dropouts: the fused AFNB output's, then the classifier's."""

    n_dropout = 2

    def __init__(self, in_channels: Sequence[int], num_classes: int,
                 channels: int = 512, project_channels: int = 256,
                 query_scales: Tuple[int, ...] = (1,),
                 key_pool_scales: Tuple[int, ...] = (1, 3, 6, 8),
                 in_index: Tuple[int, ...] = (2, 3),
                 dropout_ratio: float = DROPOUT):
        super().__init__()
        if any(s != 1 for s in query_scales):
            raise ValueError(f"query_scales {query_scales}: only 1 is "
                             "supported, as in the reference")
        self.in_index = tuple(in_index)
        self.n_scales = len(query_scales)
        low, high = (in_channels[i] for i in self.in_index)
        for i in range(self.n_scales):
            self.add_module(f"afnb_{i}", SelfAttentionBlock(
                low, high, project_channels, high, key_query_num_convs=1,
                value_out_norm=False, key_pool_scales=key_pool_scales))
        self.afnb_bottleneck = ConvModule(2 * high, high, 1, act=None)
        self.dropout = Dropout(dropout_ratio)
        self.bottleneck = ConvModule(high, channels, 3)
        for i in range(self.n_scales):
            self.add_module(f"apnb_{i}", SelfAttentionBlock(
                channels, channels, project_channels, channels,
                key_query_num_convs=1, value_out_norm=False,
                share_key_query=True, key_pool_scales=key_pool_scales))
        self.apnb_bottleneck = ConvModule(2 * channels, channels, 1)
        self.cls = ClsSeg(channels, num_classes, dropout_ratio)

    def forward(self, inputs, fused_mask=None, mask=None):
        low, high = (inputs[i] for i in self.in_index)
        priors = sum(getattr(self, f"afnb_{i}")(high, low)
                     for i in range(self.n_scales))
        fused = self.afnb_bottleneck(torch.cat([priors, high], dim=1))
        x = self.bottleneck(self.dropout(fused, fused_mask))
        priors = sum(getattr(self, f"apnb_{i}")(x, x)
                     for i in range(self.n_scales))
        x = self.apnb_bottleneck(torch.cat([priors, x], dim=1))
        return self.cls(x, mask)


class ACM(nn.Module):
    """Adaptive context module: pooled (s x s) and reduced features; an
    affinity of s^2 sigmoid gates per position (a 1x1 conv over the
    reduced features plus their global context) weights the pooled
    features; a 1x1 ConvModule, the residual, ReLU, and a 1x1 fusion."""

    def __init__(self, in_ch: int, pool_scale: int, channels: int,
                 fusion: bool = True):
        super().__init__()
        self.pool_scale, self.fusion = pool_scale, fusion
        self.pooled_redu_conv = ConvModule(in_ch, channels, 1)
        self.input_redu_conv = ConvModule(in_ch, channels, 1)
        self.global_info = ConvModule(channels, channels, 1)
        self.gla = conv(channels, pool_scale ** 2, 1, bias=True)
        self.residual_conv = ConvModule(channels, channels, 1)
        if fusion:
            self.fusion_conv = ConvModule(channels, channels, 1)

    def forward(self, x):
        b, _, h, w = x.shape
        pooled = self.pooled_redu_conv(adaptive_avg_pool(x, self.pool_scale))
        x = self.input_redu_conv(x)
        gi = self.global_info(adaptive_avg_pool(x, 1))
        affinity = torch.sigmoid(self.gla(x + resize(gi, (h, w))).flatten(2))
        z = torch.matmul(pooled.flatten(2), affinity)   # (b, c, hw)
        z = self.residual_conv(z.reshape(b, -1, h, w))
        z = F.relu(z + x)
        return self.fusion_conv(z) if self.fusion else z


class APCHead(nn.Module):
    """APCNet's head: ACMs at scales (1, 2, 3, 6) concatenated after the
    input, a 3x3 bottleneck, ClsSeg."""

    def __init__(self, in_channels: Sequence[int], num_classes: int,
                 channels: int = 512,
                 pool_scales: Tuple[int, ...] = (1, 2, 3, 6),
                 fusion: bool = True, in_index: Any = -1,
                 input_transform: Optional[str] = None,
                 dropout_ratio: float = DROPOUT):
        super().__init__()
        self.in_index, self.input_transform = in_index, input_transform
        self.pool_scales = tuple(pool_scales)
        in_ch = input_channels(in_channels, in_index, input_transform)
        for s in pool_scales:
            self.add_module(f"acm_{s}", ACM(in_ch, s, channels, fusion))
        self.bottleneck = ConvModule(in_ch + len(pool_scales) * channels,
                                     channels, 3)
        self.cls = ClsSeg(channels, num_classes, dropout_ratio)

    def forward(self, inputs, mask=None):
        x = transform_inputs(inputs, self.in_index, self.input_transform)
        outs = [x] + [getattr(self, f"acm_{s}")(x) for s in self.pool_scales]
        return self.cls(self.bottleneck(torch.cat(outs, dim=1)), mask)


class DCM(nn.Module):
    """Dynamic convolutional module: a per-sample, per-channel k x k
    filter (a 1x1 conv of the k x k adaptive pool) applied to the reduced
    features, as one grouped convolution over the folded batch (zero
    padding (k-1)/2, one more before than after for even k); BatchNorm,
    ReLU, and a 1x1 fusion with ``fusion``."""

    def __init__(self, in_ch: int, filter_size: int, channels: int,
                 fusion: bool = True):
        super().__init__()
        self.k, self.fusion = filter_size, fusion
        self.filter_gen_conv = conv(in_ch, channels, 1, bias=True)
        self.input_redu_conv = ConvModule(in_ch, channels, 1)
        self.norm = BatchNorm(channels)
        if fusion:
            self.fusion_conv = ConvModule(channels, channels, 1)

    def forward(self, x):
        k = self.k
        filt = self.filter_gen_conv(adaptive_avg_pool(x, k))  # (b, c, k, k)
        x = self.input_redu_conv(x)
        b, c, h, w = x.shape
        pad = (k - 1) // 2
        lo, hi = (pad, pad) if (k - 1) % 2 == 0 else (pad + 1, pad)
        xp = F.pad(x, (lo, hi, lo, hi)).reshape(1, b * c, h + k - 1,
                                                w + k - 1)
        out = F.conv2d(xp, filt.reshape(b * c, 1, k, k), groups=b * c)
        out = F.relu(self.norm(out.reshape(b, c, h, w)))
        return self.fusion_conv(out) if self.fusion else out


class DMHead(nn.Module):
    """DMNet's head: DCMs with filters (1, 3, 5, 7) concatenated after the
    input, a 3x3 bottleneck, ClsSeg (``fusion`` off, the reference's
    default)."""

    def __init__(self, in_channels: Sequence[int], num_classes: int,
                 channels: int = 512,
                 filter_sizes: Tuple[int, ...] = (1, 3, 5, 7),
                 fusion: bool = False, in_index: Any = -1,
                 input_transform: Optional[str] = None,
                 dropout_ratio: float = DROPOUT):
        super().__init__()
        self.in_index, self.input_transform = in_index, input_transform
        self.filter_sizes = tuple(filter_sizes)
        in_ch = input_channels(in_channels, in_index, input_transform)
        for k in filter_sizes:
            self.add_module(f"dcm_{k}", DCM(in_ch, k, channels, fusion))
        self.bottleneck = ConvModule(in_ch + len(filter_sizes) * channels,
                                     channels, 3)
        self.cls = ClsSeg(channels, num_classes, dropout_ratio)

    def forward(self, inputs, mask=None):
        x = transform_inputs(inputs, self.in_index, self.input_transform)
        outs = [x] + [getattr(self, f"dcm_{k}")(x) for k in self.filter_sizes]
        return self.cls(self.bottleneck(torch.cat(outs, dim=1)), mask)


def _l2_normalize(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=dim, keepdim=True),
                           min=1e-12)


class EMAHead(nn.Module):
    """Expectation-maximization attention. ``bases`` (C, K) are running
    state beside the BatchNorm statistics (a buffer: saved, restored and
    loaded from flax's ``batch_stats``), drawn at construction as
    normal * sqrt(2 / K) and L2-normalized per base. The EM iterations
    (softmax responsibilities, bases as responsibility-weighted means,
    renormalized) and the reconstruction from the last iteration's
    responsibilities carry no gradient, so ``ema_mid_conv`` gets none. A
    train forward blends the batch's mean bases, renormalized, into the
    buffer with ``momentum``; eval leaves it."""

    def __init__(self, in_channels: Sequence[int], num_classes: int,
                 channels: int = 512, ema_channels: int = 256,
                 num_bases: int = 64, num_stages: int = 3,
                 momentum: float = 0.1, concat_input: bool = True,
                 in_index: Any = -1, input_transform: Optional[str] = None,
                 dropout_ratio: float = DROPOUT):
        super().__init__()
        self.in_index, self.input_transform = in_index, input_transform
        self.num_stages, self.momentum = num_stages, momentum
        self.concat_input = concat_input
        in_ch = input_channels(in_channels, in_index, input_transform)
        self.ema_in_conv = ConvModule(in_ch, ema_channels, 3)
        self.ema_mid_conv = conv(ema_channels, ema_channels, 1, bias=True)
        bases = torch.randn(ema_channels, num_bases) * math.sqrt(
            2.0 / num_bases)
        self.register_buffer("bases", _l2_normalize(bases, 0))
        self.ema_out_conv = ConvModule(ema_channels, ema_channels, 1,
                                       act=None)
        self.bottleneck = ConvModule(ema_channels, channels, 3)
        if concat_input:
            self.conv_cat = ConvModule(in_ch + channels, channels, 3)
        self.cls = ClsSeg(channels, num_classes, dropout_ratio)

    def forward(self, inputs, mask=None):
        x = transform_inputs(inputs, self.in_index, self.input_transform)
        identity = self.ema_in_conv(x)
        b, c, h, w = identity.shape
        with torch.no_grad():
            flat = _tokens(self.ema_mid_conv(identity))       # (b, n, c)
            bases = self.bases.expand(b, -1, -1)
            for _ in range(self.num_stages):
                attn = torch.softmax(torch.matmul(flat, bases), dim=2)
                normed = attn / torch.clamp(attn.sum(dim=1, keepdim=True),
                                            min=1e-12)
                bases = _l2_normalize(
                    torch.matmul(flat.transpose(1, 2), normed), 1)
            recon = torch.matmul(attn, bases.transpose(1, 2))  # (b, n, c)
            if self.training:
                mean = _l2_normalize(bases.mean(dim=0), 0)
                self.bases.copy_((1 - self.momentum) * self.bases
                                 + self.momentum * mean)
        recon = F.relu(recon.transpose(1, 2).reshape(b, c, h, w))
        feats = F.relu(identity + self.ema_out_conv(recon))
        feats = self.bottleneck(feats)
        if self.concat_input:
            feats = self.conv_cat(torch.cat([x, feats], dim=1))
        return self.cls(feats, mask)


# -- DA / PSA / Enc / OCR ------------------------------------------------------

class DAHead(nn.Module):
    """Dual attention: position attention (queries and keys at C/8,
    unscaled softmax over positions, added with ``pam_gamma``) and channel
    attention (softmax of max-minus-energy over channels, added with
    ``cam_gamma``), each between 3x3 ConvModules; their sum goes through
    ClsSeg. ``pam_cls``/``cam_cls`` hold the auxiliary classifiers'
    parameters; the forward runs neither."""

    def __init__(self, in_channels: Sequence[int], num_classes: int,
                 channels: int = 512, pam_reduction: int = 8,
                 in_index: Any = -1, input_transform: Optional[str] = None,
                 dropout_ratio: float = DROPOUT):
        super().__init__()
        self.in_index, self.input_transform = in_index, input_transform
        in_ch = input_channels(in_channels, in_index, input_transform)
        inter = max(channels // pam_reduction, 1)
        self.pam_in_conv = ConvModule(in_ch, channels, 3)
        self.pam_query = conv(channels, inter, 1, bias=True)
        self.pam_key = conv(channels, inter, 1, bias=True)
        self.pam_value = conv(channels, channels, 1, bias=True)
        self.pam_gamma = nn.Parameter(torch.zeros(()))
        self.pam_out_conv = ConvModule(channels, channels, 3)
        self.cam_in_conv = ConvModule(in_ch, channels, 3)
        self.cam_gamma = nn.Parameter(torch.zeros(()))
        self.cam_out_conv = ConvModule(channels, channels, 3)
        self.cls = ClsSeg(channels, num_classes, dropout_ratio)
        self.pam_cls = ClsSeg(channels, num_classes, dropout_ratio)
        self.cam_cls = ClsSeg(channels, num_classes, dropout_ratio)

    def forward(self, inputs, mask=None):
        x = transform_inputs(inputs, self.in_index, self.input_transform)
        p = self.pam_in_conv(x)
        b, c, h, w = p.shape
        q, k = _tokens(self.pam_query(p)), _tokens(self.pam_key(p))
        v = _tokens(self.pam_value(p))
        attn = torch.softmax(torch.matmul(q, k.transpose(1, 2)), dim=-1)
        ctx = torch.matmul(attn, v).transpose(1, 2).reshape(b, c, h, w)
        pam = self.pam_out_conv(p + self.pam_gamma * ctx)
        ca = self.cam_in_conv(x)
        flat = ca.flatten(2)                                  # (b, c, n)
        energy = torch.matmul(flat, flat.transpose(1, 2))     # (b, c, c)
        energy = energy.max(dim=-1, keepdim=True)[0] - energy
        ctx = torch.matmul(torch.softmax(energy, dim=-1), flat)
        cam = self.cam_out_conv(ca + self.cam_gamma * ctx.reshape(b, c, h, w))
        return self.cls(pam + cam, mask)


@functools.lru_cache(maxsize=None)
def _psa_index(h: int, w: int, mask_h: int, mask_w: int,
               mode: str) -> Tuple[np.ndarray, np.ndarray]:
    """For the (h*w) x (h*w) attention of ``psa_mask_attention``: the
    index of each (source s, target t) entry into the flattened
    (position, offset) logits, and whether it lies inside the mask."""
    half_h, half_w = (mask_h - 1) // 2, (mask_w - 1) // 2
    sh, sw = np.divmod(np.arange(h * w), w)
    s_h, t_h = sh[:, None], sh[None, :]
    s_w, t_w = sw[:, None], sw[None, :]
    if mode == "collect":        # target t's map at offset s - t + half
        pos = np.broadcast_to(np.arange(h * w)[None, :], (h * w, h * w))
        oh, ow = s_h - t_h + half_h, s_w - t_w + half_w
    elif mode == "distribute":   # source s's map at offset t - s + half
        pos = np.broadcast_to(np.arange(h * w)[:, None], (h * w, h * w))
        oh, ow = t_h - s_h + half_h, t_w - s_w + half_w
    else:
        raise ValueError(mode)
    valid = (oh >= 0) & (oh < mask_h) & (ow >= 0) & (ow < mask_w)
    idx = pos * (mask_h * mask_w) + np.where(valid, oh * mask_w + ow, 0)
    return idx.astype(np.int64), valid


# (h, w, mask, mode, device) -> the index and validity on the device
_PSA_INDEX: dict = {}


def psa_mask_attention(logits: torch.Tensor, mask_size: Tuple[int, int],
                       mode: str) -> torch.Tensor:
    """mmcv's ``PSAMask`` as an index gather. ``logits``: (b, mh*mw, h, w),
    each position's map over relative offsets. Returns the dense
    (b, h*w [source s], h*w [target t]) attention: for ``collect`` target
    t's map at offset s - t + half, for ``distribute`` source s's map at
    offset t - s + half; 0 outside the mask (before any softmax, as mmcv
    fills it)."""
    b, _, h, w = logits.shape
    key = (h, w, tuple(mask_size), mode, logits.device)
    if key not in _PSA_INDEX:
        idx, valid = _psa_index(h, w, *mask_size, mode)
        _PSA_INDEX[key] = (torch.from_numpy(idx).to(logits.device),
                           torch.from_numpy(valid).to(logits.device))
    idx, valid = _PSA_INDEX[key]
    z = _tokens(logits).reshape(b, -1)             # (b, h*w*mh*mw)
    attn = z[:, idx]
    return torch.where(valid, attn, torch.zeros((), dtype=attn.dtype,
                                                device=attn.device))


class PSAHead(nn.Module):
    """Point-wise spatial attention (PSANet): per direction ("collect",
    "distribute", or both with "bi-direction") a 1x1 reduction, shrunk by
    ``shrink_factor`` (rounded up, and every later resize then
    corner-aligned, when both sides are odd multiples), a 1x1 ConvModule
    and a 1x1 conv to the mask's offsets, attention over sources
    (softmax), features gathered and divided by ``normalization_factor``;
    the directions concatenated, zero-padded by a pixel ring, projected
    by a 1x1 ConvModule, resized back, concatenated after the input, a
    3x3 bottleneck, ClsSeg. ``compact``: the attention conv's channels are
    read as the target positions themselves (the collect branch alone, or
    the distribute branch of bi-direction)."""

    def __init__(self, in_channels: Sequence[int], num_classes: int,
                 channels: int = 512, mask_size: Tuple[int, int] = (97, 97),
                 psa_type: str = "bi-direction", compact: bool = False,
                 shrink_factor: int = 2, psa_softmax: bool = True,
                 normalization_factor: Optional[float] = 1.0,
                 in_index: Any = -1, input_transform: Optional[str] = None,
                 dropout_ratio: float = DROPOUT):
        super().__init__()
        if psa_type not in ("collect", "distribute", "bi-direction"):
            raise ValueError(psa_type)
        self.in_index, self.input_transform = in_index, input_transform
        self.mask_size = tuple(mask_size)
        self.psa_type, self.compact = psa_type, compact
        self.shrink_factor, self.psa_softmax = shrink_factor, psa_softmax
        self.norm = (float(mask_size[0] * mask_size[1])
                     if normalization_factor is None
                     else normalization_factor)
        self.dirns = (("collect", "distribute") if psa_type == "bi-direction"
                      else (psa_type,))
        in_ch = input_channels(in_channels, in_index, input_transform)
        n_attn = mask_size[0] * mask_size[1]
        for d in self.dirns:
            self.add_module(f"reduce_{d}", ConvModule(in_ch, channels, 1))
            self.add_module(f"attention_{d}_0",
                            ConvModule(channels, channels, 1))
            self.add_module(f"attention_{d}_1",
                            conv(channels, n_attn, 1))
        self.proj = ConvModule(len(self.dirns) * channels, in_ch, 1)
        self.bottleneck = ConvModule(2 * in_ch, channels, 3)
        self.cls = ClsSeg(channels, num_classes, dropout_ratio)

    def _attend(self, y, a, dirn, compact):
        b, c, h, w = y.shape
        if compact:
            attn = _tokens(a)            # (position = source, target)
        else:
            attn = psa_mask_attention(a, self.mask_size, dirn)
        if self.psa_softmax:
            attn = torch.softmax(attn, dim=1)
        out = torch.matmul(y.flatten(2), attn)           # (b, c, targets)
        return (out * (1.0 / self.norm)).reshape(b, c, h, w)

    def forward(self, inputs, mask=None):
        x = transform_inputs(inputs, self.in_index, self.input_transform)
        reduced = [getattr(self, f"reduce_{d}")(x) for d in self.dirns]
        h, w = reduced[0].shape[2:]
        align = False
        f = self.shrink_factor
        if f != 1:
            if h % f and w % f:
                h, w, align = (h - 1) // f + 1, (w - 1) // f + 1, True
            else:
                h, w = h // f, w // f
            reduced = [bilinear_resize(y, (h, w), align) for y in reduced]
        outs = []
        for d, y in zip(self.dirns, reduced):
            a = getattr(self, f"attention_{d}_1")(
                getattr(self, f"attention_{d}_0")(y))
            compact = self.compact and d == (
                "distribute" if self.psa_type == "bi-direction"
                else "collect")
            if compact and a.shape[1] != h * w:
                raise ValueError(f"compact PSA needs mask_size == the shrunk "
                                 f"grid ({self.mask_size} vs {(h, w)})")
            outs.append(self._attend(y, a, d, compact))
        out = self.proj(F.pad(torch.cat(outs, dim=1), (1, 1, 1, 1)))
        out = bilinear_resize(out, x.shape[2:], align)
        return self.cls(self.bottleneck(torch.cat([x, out], dim=1)), mask)


class EncHead(nn.Module):
    """EncNet's head: a 3x3 bottleneck on the top stage (fused with 1x1
    laterals of the others with ``add_lateral``), then the encoding
    module: a 1x1 ConvModule projection, soft assignment of each position
    to ``num_codes`` codewords by scaled squared distance (``scale`` < 0),
    the assignment-weighted residuals per code, BatchNorm over the code
    axis, ReLU, their mean as the encoded feature, and a sigmoid channel
    gate relu(x + x * gate) on the bottleneck's output; ClsSeg.

    The squared distances are ||x||^2 - 2 x.c + ||c||^2 and the aggregated
    residuals sum_n a x - (sum_n a) c: the reference's expressions
    expanded, so no (b, positions, codes, channels) tensor is formed.
    ``se_layer`` holds the class-presence head's parameters (the se loss
    of the reference's training); the forward does not run it."""

    def __init__(self, in_channels: Sequence[int], num_classes: int,
                 channels: int = 512, num_codes: int = 32,
                 add_lateral: bool = False, use_se_loss: bool = True,
                 in_index: Tuple[int, ...] = (0, 1, 2, 3),
                 dropout_ratio: float = DROPOUT):
        super().__init__()
        self.in_index = tuple(in_index)
        self.add_lateral = add_lateral
        chans = [in_channels[i] for i in self.in_index]
        self.bottleneck = ConvModule(chans[-1], channels, 3)
        if add_lateral:
            for i, c in enumerate(chans[:-1]):
                self.add_module(f"lateral_{i}", ConvModule(c, channels, 1))
            self.fusion = ConvModule(len(chans) * channels, channels, 3)
        self.encoding_project = ConvModule(channels, channels, 1)
        std = 1.0 / (num_codes * channels) ** 0.5
        self.codewords = nn.Parameter(
            torch.empty(num_codes, channels).uniform_(-std, std))
        self.scale = nn.Parameter(torch.empty(num_codes).uniform_(-1.0, 0.0))
        self.enc_bn = BatchNorm(num_codes)
        self.fc = dense(channels, channels)
        self.cls = ClsSeg(channels, num_classes, dropout_ratio)
        if use_se_loss:
            self.se_layer = dense(channels, num_classes)

    def forward(self, inputs, mask=None):
        xs = [inputs[i] for i in self.in_index]
        feat = self.bottleneck(xs[-1])
        if self.add_lateral:
            laterals = [resize(getattr(self, f"lateral_{i}")(x),
                               feat.shape[2:])
                        for i, x in enumerate(xs[:-1])]
            feat = self.fusion(torch.cat([feat] + laterals, dim=1))
        flat = _tokens(self.encoding_project(feat))            # (b, n, c)
        cw = self.codewords
        dist = ((flat * flat).sum(-1, keepdim=True)
                - 2.0 * torch.matmul(flat, cw.t())
                + (cw * cw).sum(-1)) * self.scale              # (b, n, K)
        assign = torch.softmax(dist, dim=2)
        encoded = (torch.matmul(assign.transpose(1, 2), flat)
                   - assign.sum(dim=1)[..., None] * cw)        # (b, K, c)
        encoded = F.relu(self.enc_bn(encoded))
        gamma = torch.sigmoid(self.fc(encoded.mean(dim=1)))
        out = F.relu(feat + feat * gamma[:, :, None, None])
        return self.cls(out, mask)


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
