"""Momentum feature discriminator (port of
``aadg_tpu/models/discriminator.py:29-114``).

An online MLP head (in -> 128 + LeakyReLU 0.2 -> domains) trains with soft
cross-entropy; its EMA copy, the momentum branch, embeds features for the
Sinkhorn rewards without gradients. nn.Linear's default init is the torch
init the JAX package reproduces.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F


class MLPHead(nn.Module):
    """``dis`` (in -> 128, LeakyReLU 0.2) and ``fc`` (128 -> classes)."""

    def __init__(self, in_channels: int, num_classes: int):
        super().__init__()
        self.dis = nn.Linear(in_channels, 128)
        self.fc = nn.Linear(128, num_classes)

    def forward(self, x, return_feature: bool = False):
        fe = F.leaky_relu(self.dis(x), negative_slope=0.2)
        out = self.fc(fe)
        return (out, fe) if return_feature else out


class MomentumFeatureDiscriminator(nn.Module):
    def __init__(self, num_classes: int, in_channels: int, m: float = 0.999):
        super().__init__()
        self.m = m
        self.online = MLPHead(in_channels, num_classes)
        self.momentum = MLPHead(in_channels, num_classes)
        for p in self.momentum.parameters():
            p.requires_grad_(False)

    def forward(self, x, momentum: bool = False,
                return_feature: bool = False):
        if momentum:
            with torch.no_grad():
                return self.momentum(x.detach(), return_feature)
        return self.online(x, return_feature)


@torch.no_grad()
def momentum_update(disc: MomentumFeatureDiscriminator,
                    m: float = 0.999) -> None:
    """In place: k <- m * k + (1 - m) * q for every momentum parameter k."""
    for k, q in zip(disc.momentum.parameters(), disc.online.parameters()):
        k.mul_(m).add_(q, alpha=1.0 - m)


@torch.no_grad()
def synchronize_parameters(disc: MomentumFeatureDiscriminator) -> None:
    """In place: copy the online branch into the momentum branch (warmup end)."""
    for k, q in zip(disc.momentum.parameters(), disc.online.parameters()):
        k.copy_(q)


def build_discriminator(name: str, num_domains: int, in_channels: int):
    if name == "momentum_feature":
        return MomentumFeatureDiscriminator(num_domains, in_channels)
    raise NotImplementedError(
        f"discriminator {name!r} is not ported yet (ROADMAP queue 1)")
