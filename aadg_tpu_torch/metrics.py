"""Train-loop metric (port of ``aadg_tpu/metrics.py::samplewise_f1``).
hd95 and the evaluation metrics wait for the evaluation slice."""

from __future__ import annotations

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
