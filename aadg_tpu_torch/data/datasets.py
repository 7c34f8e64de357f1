"""Host-side datasets: the hermetic synthetic optic and vessel pools.

The port's copy of the synthetic half of ``aadg_tpu/data/datasets.py``
(:141-288), with the same numpy generator calls so the pools are identical
byte for byte. The Fundus and RVS disk readers are not ported yet
(ROADMAP queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class DomainData:
    """One domain's images/labels."""
    name: str
    images: np.ndarray              # (N, H, W, 3) uint8
    labels: np.ndarray              # (N, H, W) uint8 (raw gray values)
    names: List[str] = field(default_factory=list)
    rois: Optional[np.ndarray] = None


class SyntheticDataset:
    """Optic-style pools: a bright disc with a darker cup on a
    domain-dependent background (mask gray levels 255/128/0 like Fundus);
    ``task="optic_tint"`` is the learning-testbed variant whose domains
    differ only by a chroma tint. Any other task gives vessel-style pools:
    random walks of bright curves (binary mask) with a circular ROI."""

    def __init__(self, task: str = "optic", n_domains: int = 3,
                 n_per_domain: int = 12, size: int = 64, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.domains = []
        for d in range(n_domains):
            imgs, labels, rois, names = [], [], [], []
            for i in range(n_per_domain):
                if task == "optic_tint":
                    img, lab = self._make_optic_tint(rng, size, d)
                elif task == "optic":
                    img, lab = self._make_optic(rng, size, d)
                else:
                    img, lab, roi = self._make_vessel(rng, size, d)
                    rois.append(roi)
                imgs.append(img)
                labels.append(lab)
                names.append(f"d{d}_{i}.png")
            self.domains.append(DomainData(
                f"SYN{d}", np.stack(imgs), np.stack(labels), names,
                rois=np.stack(rois) if rois else None))

    @staticmethod
    def _disc_and_cup(rng, size):
        yy, xx = np.mgrid[0:size, 0:size]
        cy, cx = rng.uniform(size * .3, size * .7, 2)
        r_disc = rng.uniform(size * .15, size * .25)
        r_cup = r_disc * rng.uniform(0.4, 0.7)
        disc = (yy - cy) ** 2 + (xx - cx) ** 2 < r_disc ** 2
        cup = (yy - cy) ** 2 + (xx - cx) ** 2 < r_cup ** 2
        lab = np.full((size, size), 255, np.uint8)
        lab[disc] = 128
        lab[cup] = 0
        return disc, cup, lab

    @staticmethod
    def _make_optic_tint(rng, size, domain):
        disc, cup, lab = SyntheticDataset._disc_and_cup(rng, size)
        luma = rng.normal(85.0, 15.0, (size, size, 1))
        luma[disc] += 50
        luma[cup] += 25
        tint = float(25 * (domain - 1))  # -25 / 0 / +25
        img = np.clip(luma + np.array([tint, 0.0, -tint]), 0, 255)
        return img.astype(np.uint8), lab

    @staticmethod
    def _make_optic(rng, size, domain):
        disc, cup, lab = SyntheticDataset._disc_and_cup(rng, size)
        base = 60 + 40 * domain
        img = np.clip(rng.normal(base, 15, (size, size, 3)), 0, 255)
        img[disc] = np.clip(img[disc] + 80, 0, 255)
        img[cup] = np.clip(img[cup] + 40, 0, 255)
        return img.astype(np.uint8), lab

    @staticmethod
    def _make_vessel(rng, size, domain):
        base = 40 + 30 * domain
        img = np.clip(rng.normal(base, 10, (size, size, 3)), 0, 255)
        lab = np.zeros((size, size), np.uint8)
        for _ in range(3):
            y = rng.integers(5, size - 5)
            for x in range(size):
                rows = slice(max(y - 1, 0), y + 1)
                lab[rows, x] = 255
                img[rows, x] = np.clip(img[rows, x] + 90, 0, 255)
                y = int(np.clip(y + rng.integers(-2, 3), 1, size - 2))
        yy, xx = np.mgrid[0:size, 0:size]
        roi = (((yy - size / 2) ** 2 + (xx - size / 2) ** 2)
               < (size * 0.48) ** 2).astype(np.uint8) * 255
        return img.astype(np.uint8), lab, roi


def build_dataset(cfg, phase: str):
    """Dataset factory for the ``synthetic*`` names: ``*optic_tint*``,
    ``*optic*``, and the vessel task (with ROIs) for any other."""
    name = cfg.DATASET.NAME
    if not name.startswith("synthetic"):
        raise NotImplementedError(
            f"dataset {name!r} is not ported yet (ROADMAP queue 1)")
    task = ("optic_tint" if "optic_tint" in name
            else "optic" if "optic" in name else "rvs")
    n_dom = 3 if phase == "train" else 1
    size = int(cfg.TPU.SYNTHETIC_SIZE)
    return SyntheticDataset(task=task, n_domains=n_dom,
                            n_per_domain=12 if phase == "train" else 4,
                            size=size, seed=0 if phase == "train" else 1)


def load_train_arrays(dataset):
    """Pad per-domain pools to a common N and stack:
    (D, Nmax, H, W, 3) u8 images, (D, Nmax, H, W) u8 labels, counts (D,)."""
    domains = dataset.domains
    n_max = max(d.images.shape[0] for d in domains)
    imgs, labels, counts = [], [], []
    for d in domains:
        n = d.images.shape[0]
        pad = [(0, n_max - n)] + [(0, 0)] * (d.images.ndim - 1)
        imgs.append(np.pad(d.images, pad))
        labels.append(np.pad(d.labels, pad[:d.labels.ndim]))
        counts.append(n)
    return (np.stack(imgs), np.stack(labels),
            np.asarray(counts, np.int32))


def load_test_arrays(dataset):
    """Flatten all test-domain samples: images (N,H,W,3), labels (N,H,W),
    rois (N,H,W) or None, names."""
    imgs, labels, rois, names = [], [], [], []
    has_roi = all(d.rois is not None for d in dataset.domains)
    for d in dataset.domains:
        imgs.append(d.images)
        labels.append(d.labels)
        names.extend(d.names)
        if has_roi:
            rois.append(d.rois)
    return (np.concatenate(imgs), np.concatenate(labels),
            np.concatenate(rois) if has_roi else None, names)
