"""Device-resident training store and the domain-balanced batch sampler.

Port of ``aadg_tpu/data/stores.py:25-97``: the whole training corpus lives
on the device as uint8, and a batch is one index draw plus one gather.
The draw (``draw_batch_indices``) and the gather (``gather_batch``) are
separate so the gather can be held to the JAX sampler given the same
indices.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class TrainStore(NamedTuple):
    images: torch.Tensor   # (D, Nmax, H, W, 3) uint8
    labels: torch.Tensor   # (D, Nmax, H, W) uint8
    counts: torch.Tensor   # (D,) int64, on the host

    @property
    def n_domains(self) -> int:
        return self.images.shape[0]

    def steps_per_epoch(self, batch_size: int) -> int:
        """ceil(largest pool / batch), the optic epoch length."""
        return max(1, math.ceil(int(self.counts.max()) / batch_size))


def make_train_store(images: np.ndarray, labels: np.ndarray,
                     counts: np.ndarray, device) -> TrainStore:
    return TrainStore(torch.as_tensor(images).to(device),
                      torch.as_tensor(labels).to(device),
                      torch.as_tensor(counts, dtype=torch.int64))


def draw_batch_indices(store: TrainStore, batch_size: int,
                       generator: torch.Generator) -> torch.Tensor:
    """(B, D) int64: one uniform pool index per (batch row, domain)
    (the draw of ``stores.py:84``)."""
    d = store.n_domains
    u = torch.rand((batch_size, d), generator=generator,
                   device=generator.device)
    counts = store.counts.to(u.device)
    # floor(u * count) < count unless u rounds up to 1 in the product
    return torch.minimum((u * counts).long(), counts - 1)


def gather_batch(store: TrainStore, idx: torch.Tensor):
    """(B, D, H, W, 3) f32 images in [0,255], (B, D, H, W) f32 raw masks,
    (B, D) int64 domain codes for the pool indices ``idx`` (B, D)."""
    idx = idx.to(store.images.device)
    d = store.n_domains
    dom = torch.arange(d, device=idx.device)[None, :].expand_as(idx)
    imgs = store.images[dom, idx].float()
    masks = store.labels[dom, idx].float()
    return imgs, masks, dom.clone()
