"""Metrics (port of ``aadg_tpu/metrics.py``): ``samplewise_f1`` (:29-53)
and ``dice_coef`` (:56-63) in torch; the rvs binary metrics ``auroc``,
``accuracy_score``, ``specificity`` and ``sensitivity`` at threshold 0.5,
ROI-maskable (:70-121), and the optic hd95 family (:128-162), which run on
the host with numpy and scipy as in the reference."""

from __future__ import annotations

import numpy as np
import torch


def samplewise_f1(pred: torch.Tensor, target: torch.Tensor,
                  weight: torch.Tensor | None = None) -> torch.Tensor:
    """Per-class F1 per sample, averaged over samples: (2,) tensor
    [f1_class0, f1_class1]; a sample whose denominator is 0 scores 0.
    ``weight`` (N,) optionally masks whole samples."""
    pred = pred.reshape(pred.shape[0], -1).float()
    target = target.reshape(target.shape[0], -1).float()

    def per_class(p, t):
        tp = torch.sum(p * t, dim=1)
        fp = torch.sum(p * (1.0 - t), dim=1)
        fn = torch.sum((1.0 - p) * t, dim=1)
        denom = 2.0 * tp + fp + fn
        f1 = torch.where(denom > 0, 2.0 * tp / torch.clamp(denom, min=1e-12),
                         0.0)
        if weight is not None:
            w = weight.float()
            return torch.sum(f1 * w) / torch.clamp(torch.sum(w), min=1e-12)
        return torch.mean(f1)

    return torch.stack([per_class(1.0 - pred, 1.0 - target),
                        per_class(pred, target)])


def dice_coef(pred: torch.Tensor, target: torch.Tensor,
              eps: float = 1e-8) -> torch.Tensor:
    """Plain Dice over the whole batch per channel. pred/target: (N, H, W, C)
    binary. Returns (C,)."""
    axes = tuple(range(pred.dim() - 1))
    inter = torch.sum(pred * target, dim=axes)
    card = torch.sum(pred, dim=axes) + torch.sum(target, dim=axes)
    return 2.0 * inter / (card + eps)


def _masked(arr, mask) -> np.ndarray:
    arr = np.asarray(arr).reshape(-1)
    if mask is None:
        return arr
    return arr[np.asarray(mask).reshape(-1).astype(bool)]


def auroc(scores, labels, mask=None) -> float:
    """Exact binary AUROC: Mann-Whitney U with average ranks for tied
    scores; nan when one class is empty. Each run of equal scores gets the
    mean of the 1-based ranks it spans."""
    s = _masked(scores, mask).astype(np.float64)
    y = _masked(labels, mask).astype(np.int64)
    n_pos = int(y.sum())
    n_neg = int(y.size - n_pos)
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    _, run, counts = np.unique(s, return_inverse=True, return_counts=True)
    ends = np.cumsum(counts)                     # rank of a run's last score
    ranks = (ends - 0.5 * (counts - 1))[run.reshape(-1)].astype(np.float64)
    r_pos = ranks[y == 1].sum()
    return float((r_pos - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def accuracy_score(scores, labels, mask=None, threshold=0.5) -> float:
    s = _masked(scores, mask)
    y = _masked(labels, mask)
    return float(np.mean((s > threshold).astype(np.int64)
                         == y.astype(np.int64)))


def specificity(scores, labels, mask=None, threshold=0.5) -> float:
    """TN / (TN + FP)."""
    p = _masked(scores, mask) > threshold
    y = _masked(labels, mask).astype(bool)
    tn = np.sum(~p & ~y)
    fp = np.sum(p & ~y)
    return float(tn / max(tn + fp, 1))


def sensitivity(scores, labels, mask=None, threshold=0.5) -> float:
    """TP / (TP + FN)."""
    p = _masked(scores, mask) > threshold
    y = _masked(labels, mask).astype(bool)
    tp = np.sum(p & y)
    fn = np.sum(~p & y)
    return float(tp / max(tp + fn, 1))


def _surface(arr: np.ndarray) -> np.ndarray:
    """Border pixels of a binary mask (medpy's surface erosion)."""
    from scipy import ndimage
    arr = np.atleast_2d(np.asarray(arr).astype(bool))
    conn = ndimage.generate_binary_structure(arr.ndim, 1)
    eroded = ndimage.binary_erosion(arr, structure=conn, iterations=1)
    return arr ^ eroded


def _surface_distances(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distances from each surface pixel of ``a`` to the surface of ``b``."""
    from scipy import ndimage
    sa = _surface(a)
    sb = _surface(b)
    dt = ndimage.distance_transform_edt(~sb)
    return dt[sa]


def hd95(pred: np.ndarray, target: np.ndarray) -> float:
    """95th percentile of the pooled bidirectional surface distances
    (medpy ``binary.hd95``). Both inputs must be non-empty binary masks."""
    d1 = _surface_distances(pred, target)
    d2 = _surface_distances(target, pred)
    return float(np.percentile(np.hstack((d1, d2)), 95))


def hd95_with_penalty(pred: np.ndarray, target: np.ndarray,
                      penalty: float = 100.0) -> float:
    """hd95, or ``penalty`` when either mask is empty (the reference's
    empty-prediction penalty)."""
    pred = np.asarray(pred).astype(bool)
    target = np.asarray(target).astype(bool)
    if pred.sum() < 1 or target.sum() < 1:
        return penalty
    return hd95(pred, target)
