"""SegFormer: the Mix Transformer (MiT) encoder and the all-MLP decode head
(port of ``aadg_tpu/models/segformer.py``), variants b0-b5.

``model(x, dropout=None) -> (logits, feature)``: NHWC images in, NHWC
logits at the input resolution and the last stage's pooled feature
(N, dims[-1]) out, the discriminator's input. Submodules carry the flax
module names (``backbone.patch_embed1``, ``backbone.block3_26.attn.kv``,
``head.linear_c1``, ``head.BatchNorm_0`` ...) for ``weights.from_flax``.

Random draws: the JAX model draws its stochastic-depth (``DropPath``) and
head-dropout masks inside ``apply``. Here they are drawn beforehand by
``draw_dropout`` and passed in, so a block recomputed under activation
checkpointing (``remat``, ``TPU.REMAT``) applies the masks of its forward
pass; ``torch.utils.checkpoint`` would restore only the global RNG, not a
``torch.Generator``. A train-mode forward with a nonzero rate needs them;
eval applies none.

Attention is ``matmul`` -> ``softmax`` -> ``matmul``, as the JAX module
writes it, with the MiT spatial reduction (a stride-``sr`` convolution
with flax's SAME padding) on keys and values. Bilinear upsampling is
``F.interpolate`` with half-pixel centres, which equals
``jax.image.resize(..., "bilinear")`` when upsampling. The JAX model has
no compute dtype: it runs in f32, so this one runs with autocast off.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional

import torch
from torch import nn
import torch.nn.functional as F

from .mobilenetv2 import BatchNorm, checkpointed, conv, lecun_normal_

VARIANTS = {
    # dims, depths, heads, sr_ratios, mlp_ratio
    "mit_b0": ((32, 64, 160, 256), (2, 2, 2, 2), (1, 2, 5, 8),
               (8, 4, 2, 1), 4),
    "mit_b1": ((64, 128, 320, 512), (2, 2, 2, 2), (1, 2, 5, 8),
               (8, 4, 2, 1), 4),
    "mit_b2": ((64, 128, 320, 512), (3, 4, 6, 3), (1, 2, 5, 8),
               (8, 4, 2, 1), 4),
    "mit_b3": ((64, 128, 320, 512), (3, 4, 18, 3), (1, 2, 5, 8),
               (8, 4, 2, 1), 4),
    "mit_b4": ((64, 128, 320, 512), (3, 8, 27, 3), (1, 2, 5, 8),
               (8, 4, 2, 1), 4),
    "mit_b5": ((64, 128, 320, 512), (3, 6, 40, 3), (1, 2, 5, 8),
               (8, 4, 2, 1), 4),
}
HEAD_DIM = 256         # the decode head's embedding width
HEAD_DROPOUT = 0.1     # BaseDecodeHead's dropout ratio
LN_EPS = 1e-6


class SegFormerDropout(NamedTuple):
    """One train-mode forward's masks (True keeps)."""
    paths: torch.Tensor   # (blocks, 2, N) bool: dp1 and dp2 of every block
    head: torch.Tensor    # (N, H/4, W/4, HEAD_DIM) bool


def drop_path_rates(variant: str, drop_path_rate: float) -> List[float]:
    """Per-block stochastic-depth rates, linear from 0 over all blocks."""
    total = sum(VARIANTS[variant][1])
    return [drop_path_rate * k / max(total - 1, 1) for k in range(total)]


def draw_dropout(variant: str, drop_path_rate: float, h: int, w: int,
                 n: int, generator: torch.Generator) -> SegFormerDropout:
    """The masks of one train-mode forward of ``n`` images of h x w, on
    the generator's device: per block a keep mask per sample for each
    residual branch (Bernoulli of 1 - rate, all kept at rate 0), and the
    head's per-element keep mask at the 1/4 resolution."""
    dev = generator.device
    total = sum(VARIANTS[variant][1])
    # drop_path_rates' f64 arithmetic, on the device: no host copy
    keep = (1.0 - drop_path_rate * torch.arange(
        total, dtype=torch.float64, device=dev) / max(total - 1, 1)).float()
    paths = torch.rand((total, 2, n), generator=generator,
                       device=dev) < keep[:, None, None]
    h4, w4 = (h - 1) // 4 + 1, (w - 1) // 4 + 1   # patch_embed1's output
    head = torch.rand((n, h4, w4, HEAD_DIM), generator=generator,
                      device=dev) < 1.0 - HEAD_DROPOUT
    return SegFormerDropout(paths, head)


def dense(in_features: int, out_features: int) -> nn.Linear:
    """A flax-initialized Dense: lecun normal kernel, zero bias."""
    layer = nn.Linear(in_features, out_features)
    lecun_normal_(layer.weight)
    nn.init.zeros_(layer.bias)
    return layer


def keep_where(x: torch.Tensor, mask: torch.Tensor, rate: float):
    """Dropout's apply: ``x / keep`` where ``mask``, else 0."""
    return torch.where(mask, x / (1.0 - rate), torch.zeros_like(x))


def attention(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over (B, heads, tokens, d)."""
    a = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    return torch.matmul(torch.softmax(a, dim=-1), v)


class OverlapPatchEmbed(nn.Module):
    def __init__(self, in_ch: int, dim: int, patch: int, stride: int):
        super().__init__()
        self.Conv_0 = conv(in_ch, dim, patch, stride, bias=True,
                           padding=patch // 2)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x):
        """NCHW -> tokens (B, h*w, dim), h, w."""
        y = self.Conv_0(x)
        b, c, h, w = y.shape
        return self.norm(y.permute(0, 2, 3, 1).reshape(b, h * w, c)), h, w


class EfficientAttention(nn.Module):
    def __init__(self, dim: int, heads: int, sr_ratio: int):
        super().__init__()
        self.heads, self.sr_ratio = heads, sr_ratio
        self.q = dense(dim, dim)
        if sr_ratio > 1:
            self.sr = conv(dim, dim, sr_ratio, sr_ratio, bias=True,
                           padding=0)
            self.sr_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.kv = dense(dim, 2 * dim)
        self.proj = dense(dim, dim)

    def forward(self, x, h: int, w: int):
        b, n, c = x.shape
        hd = c // self.heads
        q = self.q(x).reshape(b, n, self.heads, hd).transpose(1, 2)
        xs = x
        if self.sr_ratio > 1:
            r = self.sr_ratio
            xs = x.reshape(b, h, w, c).permute(0, 3, 1, 2)
            # flax's SAME padding of a stride-r, r x r window: the short
            # remainder is split, the larger half at the end
            ph, pw = -h % r, -w % r
            if ph or pw:
                xs = F.pad(xs, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
            xs = self.sr(xs)
            xs = self.sr_norm(xs.permute(0, 2, 3, 1).reshape(b, -1, c))
        kv = self.kv(xs).reshape(b, -1, 2, self.heads, hd)
        k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
        out = attention(q, k, v).transpose(1, 2).reshape(b, n, c)
        return self.proj(out)


class MixFFN(nn.Module):
    def __init__(self, dim: int, mlp_ratio: int):
        super().__init__()
        self.hidden = dim * mlp_ratio
        self.fc1 = dense(dim, self.hidden)
        # depthwise 3x3 conv injects positional information
        self.dwconv = conv(self.hidden, self.hidden, 3, groups=self.hidden,
                           bias=True)
        self.fc2 = dense(self.hidden, dim)

    def forward(self, x, h: int, w: int):
        b, n, _ = x.shape
        y = self.fc1(x).reshape(b, h, w, self.hidden).permute(0, 3, 1, 2)
        y = self.dwconv(y).permute(0, 2, 3, 1).reshape(b, n, self.hidden)
        # the official MiT uses the exact erf GELU
        return self.fc2(F.gelu(y))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, sr_ratio: int, mlp_ratio: int,
                 drop_path: float = 0.0):
        super().__init__()
        self.drop_path = drop_path
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = EfficientAttention(dim, heads, sr_ratio)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.ffn = MixFFN(dim, mlp_ratio)

    def _branch(self, y, keep: Optional[torch.Tensor]):
        if keep is None or self.drop_path == 0.0:
            return y
        return keep_where(y, keep[:, None, None], self.drop_path)

    def forward(self, x, h: int, w: int, keep1=None, keep2=None):
        x = x + self._branch(self.attn(self.norm1(x), h, w), keep1)
        return x + self._branch(self.ffn(self.norm2(x), h, w), keep2)


class MixTransformer(nn.Module):
    """NCHW images -> four NHWC stage features (strides 4, 8, 16, 32).
    ``remat`` checkpoints every block: only block inputs stay alive for
    the backward pass, which recomputes each block's activations."""

    def __init__(self, variant: str = "mit_b1", drop_path_rate: float = 0.0,
                 remat: bool = False):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"unknown MiT variant {variant!r}; one of "
                             f"{sorted(VARIANTS)}")
        dims, self.depths, heads, srs, mlp_ratio = VARIANTS[variant]
        self.remat = remat
        rates = drop_path_rates(variant, drop_path_rate)
        in_ch, cur = 3, 0
        for i in range(4):
            patch, stride = (7, 4) if i == 0 else (3, 2)
            self.add_module(f"patch_embed{i + 1}", OverlapPatchEmbed(
                in_ch, dims[i], patch, stride))
            for j in range(self.depths[i]):
                self.add_module(f"block{i + 1}_{j}", Block(
                    dims[i], heads[i], srs[i], mlp_ratio, rates[cur + j]))
            self.add_module(f"norm{i + 1}", nn.LayerNorm(dims[i], eps=LN_EPS))
            in_ch, cur = dims[i], cur + self.depths[i]

    def forward(self, x, paths: Optional[torch.Tensor] = None):
        feats, cur = [], 0
        remat = self.remat and torch.is_grad_enabled()
        for i in range(4):
            x, h, w = getattr(self, f"patch_embed{i + 1}")(x)
            for j in range(self.depths[i]):
                blk = getattr(self, f"block{i + 1}_{j}")
                keeps = (() if paths is None
                         else (paths[cur + j, 0], paths[cur + j, 1]))
                x = (checkpointed(blk, x, h, w, *keeps) if remat
                     else blk(x, h, w, *keeps))
            cur += self.depths[i]
            x = getattr(self, f"norm{i + 1}")(x)
            feats.append(x.reshape(x.shape[0], h, w, -1))
            x = feats[-1].permute(0, 3, 1, 2)
        return feats


class SegFormerHead(nn.Module):
    """All-MLP decode head: per-stage linear -> upsample to 1/4 -> concat
    (deepest first) -> 1x1 fuse -> BatchNorm -> ReLU -> dropout ->
    classifier."""

    def __init__(self, num_classes: int, dims, embed_dim: int = HEAD_DIM):
        super().__init__()
        for i, d in enumerate(dims):
            self.add_module(f"linear_c{i + 1}", dense(d, embed_dim))
        self.linear_fuse = conv(embed_dim * len(dims), embed_dim, 1)
        self.BatchNorm_0 = BatchNorm(embed_dim)
        self.linear_pred = conv(embed_dim, num_classes, 1, bias=True)

    def forward(self, feats, mask: Optional[torch.Tensor] = None):
        th, tw = feats[0].shape[1], feats[0].shape[2]
        ups = []
        for i, f in enumerate(feats):
            f = getattr(self, f"linear_c{i + 1}")(f).permute(0, 3, 1, 2)
            if f.shape[2] != th:
                f = F.interpolate(f, size=(th, tw), mode="bilinear",
                                  align_corners=False)
            ups.append(f)
        x = F.relu(self.BatchNorm_0(self.linear_fuse(torch.cat(ups[::-1],
                                                               dim=1))))
        if mask is not None:
            x = keep_where(x, mask.permute(0, 3, 1, 2), HEAD_DROPOUT)
        return self.linear_pred(x)


class SegFormer(nn.Module):
    def __init__(self, num_classes: int, variant: str = "mit_b1",
                 drop_path_rate: float = 0.0, remat: bool = False):
        super().__init__()
        self.variant = variant
        self.backbone = MixTransformer(variant, drop_path_rate, remat)
        dims = VARIANTS[variant][0]
        self.head = SegFormerHead(num_classes, dims)
        self.feature_dim = dims[-1]

    def forward(self, x: torch.Tensor,
                dropout: Optional[SegFormerDropout] = None):
        """x: (N, H, W, 3) -> logits (N, H, W, classes), feature
        (N, dims[-1]), both f32. ``dropout`` (``draw_dropout``) is
        required in train mode and ignored in eval mode."""
        if not self.training:
            dropout = None
        elif dropout is None:
            raise ValueError("a train-mode SegFormer forward needs its "
                             "dropout masks (segformer.draw_dropout)")
        with torch.autocast(device_type=x.device.type, enabled=False):
            h, w = x.shape[1], x.shape[2]
            feats = self.backbone(x.float().permute(0, 3, 1, 2),
                                  None if dropout is None else dropout.paths)
            logits = self.head(feats,
                               None if dropout is None else dropout.head)
            logits = F.interpolate(logits, size=(h, w), mode="bilinear",
                                   align_corners=False)
            feature = torch.mean(feats[-1], dim=(1, 2))
        return logits.permute(0, 2, 3, 1), feature
