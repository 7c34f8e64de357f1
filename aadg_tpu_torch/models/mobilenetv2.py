"""MobileNetV2 encoder at output stride 16 (port of
``aadg_tpu/models/mobilenetv2.py``).

Submodules carry the flax module names (``ConvBNReLU6_0``,
``InvertedResidual_3``, ``Conv_0``, ``BatchNorm_0`` ...) so a flax
parameter path maps to a state_dict key one to one (``weights.from_flax``).
Tensors are NCHW inside the model. ``remat`` (``TPU.REMAT``) checkpoints
every inverted residual, as the JAX encoder's ``nn.remat`` does.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class BatchNorm(nn.Module):
    """flax.linen.BatchNorm semantics: momentum 0.9 on the running stats
    (torch's 0.1), eps 1e-5, and the running variance blended with the
    *biased* batch variance (torch's BatchNorm2d blends the unbiased one).
    The statistics stay f32 under autocast. ``update_stats`` is cleared
    while ``checkpointed`` recomputes the forward, so a checkpointed block
    updates its running statistics once per step, as the JAX model does."""

    def __init__(self, channels: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.update_stats = True
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        n = x.numel() // x.shape[1]
        # batch_norm updates these copies; autograd keeps them, so the
        # buffers themselves are written only afterwards
        mean = self.running_mean.clone()
        var = self.running_var.clone()
        out = F.batch_norm(x, mean, var, self.weight, self.bias, True,
                           1.0 - self.momentum, self.eps)
        if not self.update_stats:
            return out
        with torch.no_grad():
            # torch blended (1 - momentum) * var * n / (n - 1); rescale that
            # term to the biased variance
            kept = self.running_var * self.momentum
            self.running_var.copy_(kept + (var - kept) * ((n - 1) / n))
            self.running_mean.copy_(mean)
        return out


@contextlib.contextmanager
def _stats_frozen(module: nn.Module):
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m in bns:
            m.update_stats = True


def checkpointed(module: nn.Module, *args):
    """``module(*args)`` with activation checkpointing: only the inputs are
    kept for the backward pass, which runs the forward again (under the
    same autocast) before differentiating it. The recomputation leaves the
    BatchNorm running statistics alone. The modules draw no random numbers
    (dropout masks are inputs), so no RNG state is saved."""
    return checkpoint(module, *args, use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          _stats_frozen(module)))


def lecun_normal_(weight: torch.Tensor) -> None:
    """flax's default kernel init: truncated normal, variance 1 / fan_in."""
    fan_in = weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, std=std, a=-2.0 * std, b=2.0 * std)


def conv(in_ch: int, out_ch: int, kernel: int, stride: int = 1,
         groups: int = 1, dilation: int = 1, bias: bool = False,
         padding: int | None = None) -> nn.Conv2d:
    """A flax-initialized Conv2d; padding defaults to 'same' for odd kernels."""
    if padding is None:
        padding = (kernel - 1) // 2 * dilation
    c = nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding,
                  dilation=dilation, groups=groups, bias=bias)
    lecun_normal_(c.weight)
    if bias:
        nn.init.zeros_(c.bias)
    return c


class ConvBNReLU6(nn.Module):
    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: int = 1, groups: int = 1, dilation: int = 1):
        super().__init__()
        self.Conv_0 = conv(in_ch, features, kernel, stride, groups, dilation)
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x):
        return F.relu6(self.BatchNorm_0(self.Conv_0(x)))


class InvertedResidual(nn.Module):
    def __init__(self, in_ch: int, features: int, stride: int,
                 expand_ratio: int, dilation: int = 1):
        super().__init__()
        hidden = int(round(in_ch * expand_ratio))
        self.use_res = stride == 1 and in_ch == features
        self.expand = expand_ratio != 1
        idx = 0
        if self.expand:
            self.ConvBNReLU6_0 = ConvBNReLU6(in_ch, hidden, kernel=1)
            idx = 1
        self.dw_name = f"ConvBNReLU6_{idx}"
        self.add_module(self.dw_name, ConvBNReLU6(
            hidden, hidden, kernel=3, stride=stride, groups=hidden,
            dilation=dilation))
        self.Conv_0 = conv(hidden, features, 1)
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x):
        y = self.ConvBNReLU6_0(x) if self.expand else x
        y = getattr(self, self.dw_name)(y)
        y = self.BatchNorm_0(self.Conv_0(y))
        return x + y if self.use_res else y


# (expand t, channels c, repeats n, stride s) -- MobileNetV2 table 2
_SETTINGS = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]


class MobileNetV2Encoder(nn.Module):
    """NCHW input -> (low_level C2 24ch @ 1/4, high_level C5 1280ch)."""

    def __init__(self, output_stride: int = 16, remat: bool = False):
        super().__init__()
        self.remat = remat
        ch = _make_divisible(32)
        self.ConvBNReLU6_0 = ConvBNReLU6(3, ch, kernel=3, stride=2)
        self.blocks = []
        current_stride, dilation, blk = 2, 1, 0
        self.low_level_after = None
        for block_idx, (t, c, n, s) in enumerate(_SETTINGS):
            out_ch = _make_divisible(c)
            for i in range(n):
                stride = s if i == 0 else 1
                if stride == 2 and current_stride >= output_stride:
                    dilation *= 2
                    stride = 1
                name = f"InvertedResidual_{blk}"
                self.add_module(name, InvertedResidual(
                    ch, out_ch, stride, t,
                    dilation=dilation if stride == 1 else 1))
                self.blocks.append(name)
                ch = out_ch
                blk += 1
                if stride == 2:
                    current_stride *= 2
            if block_idx == 1:
                self.low_level_after = blk - 1
        self.ConvBNReLU6_1 = ConvBNReLU6(ch, 1280, kernel=1)

    def forward(self, x):
        x = self.ConvBNReLU6_0(x)
        low = None
        remat = self.remat and torch.is_grad_enabled()
        for i, name in enumerate(self.blocks):
            block = getattr(self, name)
            x = checkpointed(block, x) if remat else block(x)
            if i == self.low_level_after:
                low = x
        return low, self.ConvBNReLU6_1(x)
