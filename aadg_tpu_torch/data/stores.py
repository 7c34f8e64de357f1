"""Device-resident data stores and the domain-balanced batch sampler.

Port of ``aadg_tpu/data/stores.py:25-97``: the whole training corpus lives
on the device as uint8, and a batch is one index draw plus one gather.
The draw (``draw_batch_indices``) and the gather (``gather_batch``) are
separate so the gather can be held to the JAX sampler given the same
indices. The test split is a ``TestStore``, padded to a multiple of the
evaluation batch with 0/1 weights.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch


class TrainStore(NamedTuple):
    images: torch.Tensor         # (D, Nmax, H, W, 3) uint8
    labels: torch.Tensor         # (D, Nmax, H, W) uint8
    counts: torch.Tensor         # (D,) int64, on the host
    device_counts: torch.Tensor  # the same counts on the store's device

    @property
    def n_domains(self) -> int:
        return self.images.shape[0]

    def steps_per_epoch(self, batch_size: int, length_mult: int = 1) -> int:
        """ceil(largest pool x length_mult / batch): the epoch length, with
        ``length_mult`` 3 for the rvs disk data and 1 otherwise."""
        return max(1, math.ceil(int(self.counts.max()) * length_mult
                                / batch_size))


class TestStore(NamedTuple):
    images: torch.Tensor           # (N_pad, H, W, 3) uint8
    labels: torch.Tensor           # (N_pad, H, W) uint8
    rois: Optional[torch.Tensor]   # (N_pad, H, W) uint8 or None
    weights: torch.Tensor          # (N_pad,) f32, 1.0 for real samples
    names: list                    # len N (unpadded)

    @property
    def n_real(self) -> int:
        return len(self.names)


def make_train_store(images: np.ndarray, labels: np.ndarray,
                     counts: np.ndarray, device) -> TrainStore:
    counts = torch.as_tensor(counts, dtype=torch.int64)
    return TrainStore(torch.as_tensor(images).to(device),
                      torch.as_tensor(labels).to(device), counts,
                      counts.to(device))


def make_test_store(images: np.ndarray, labels: np.ndarray,
                    rois: Optional[np.ndarray], names: list,
                    batch_size: int, device) -> TestStore:
    """The test split on ``device``, zero-padded to a multiple of
    ``batch_size`` rows (at least one batch)."""
    n = images.shape[0]
    n_pad = max(1, math.ceil(n / batch_size)) * batch_size
    pad = [(0, n_pad - n)] + [(0, 0)] * (images.ndim - 1)
    weights = np.zeros((n_pad,), np.float32)
    weights[:n] = 1.0
    put = lambda a: torch.as_tensor(a).to(device)
    return TestStore(put(np.pad(images, pad)),
                     put(np.pad(labels, pad[:labels.ndim])),
                     put(np.pad(rois, pad[:rois.ndim]))
                     if rois is not None else None,
                     put(weights), list(names))


def draw_batch_indices(store: TrainStore, batch_size: int,
                       generator: torch.Generator) -> torch.Tensor:
    """(B, D) int64: one uniform pool index per (batch row, domain)
    (the draw of ``stores.py:84``). The generator lives on the store's
    device, so the draw copies nothing from the host."""
    d = store.n_domains
    u = torch.rand((batch_size, d), generator=generator,
                   device=generator.device)
    counts = store.device_counts
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
