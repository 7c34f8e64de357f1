"""The port's metrics against ``aadg_tpu/metrics.py`` on seeded numpy
masks, empty and one-pixel masks included.

``hd95`` and ``hd95_with_penalty`` run the same numpy/scipy code, and
``dice_coef`` sums exact 0/1 counts in f32, so all three must be equal.
Weighted ``samplewise_f1`` divides f32 sums whose order may differ
between XLA and torch: within 1e-6. The rvs binary metrics (AUROC,
accuracy, specificity, sensitivity), with and without an ROI, with tied
scores and with a one-class ROI (AUROC nan), within 1e-12: both run numpy
in float64 on the same ranks and counts.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aadg_tpu import metrics as jm
from aadg_tpu_torch import metrics as tm
from torch_port_helpers import few_torch_threads  # noqa: F401


def _disc(rng, size):
    yy, xx = np.mgrid[0:size, 0:size]
    cy, cx = rng.uniform(size * .2, size * .8, 2)
    r = rng.uniform(size * .05, size * .3)
    noise = rng.random((size, size)) < 0.02
    return ((yy - cy) ** 2 + (xx - cx) ** 2 < r ** 2) ^ noise


def _one_pixel(rng, size):
    m = np.zeros((size, size), bool)
    m[tuple(rng.integers(0, size, 2))] = True
    return m


def _mask_pair(kind, seed, size=48):
    rng = np.random.default_rng(seed)
    empty = np.zeros((size, size), bool)
    return {"blobs": (_disc(rng, size), _disc(rng, size)),
            "same": (lambda m: (m, m.copy()))(_disc(rng, size)),
            "pixel_vs_blob": (_one_pixel(rng, size), _disc(rng, size)),
            "pixel_vs_pixel": (_one_pixel(rng, size), _one_pixel(rng, size)),
            "empty_pred": (empty, _disc(rng, size)),
            "empty_target": (_disc(rng, size), empty),
            "both_empty": (empty, empty.copy())}[kind]


KINDS = ["blobs", "same", "pixel_vs_blob", "pixel_vs_pixel", "empty_pred",
         "empty_target", "both_empty"]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", KINDS)
def test_hd95_with_penalty_equals_jax(kind, seed):
    pred, target = _mask_pair(kind, seed)
    got = tm.hd95_with_penalty(pred, target)
    assert got == jm.hd95_with_penalty(pred, target)
    if pred.any() and target.any():
        assert tm.hd95(pred, target) == jm.hd95(pred, target) == got
    else:
        assert got == 100.0


def test_surface_distances_equal_jax():
    pred, target = _mask_pair("blobs", 3)
    np.testing.assert_array_equal(tm._surface(pred), jm._surface(pred))
    np.testing.assert_array_equal(tm._surface_distances(pred, target),
                                  jm._surface_distances(pred, target))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dice_coef_equals_jax(seed):
    rng = np.random.default_rng(seed)
    pred = (rng.random((3, 32, 32, 2)) < 0.4).astype(np.float32)
    target = (rng.random((3, 32, 32, 2)) < 0.3).astype(np.float32)
    pred[0] = 0.0  # an empty sample
    got = tm.dice_coef(torch.from_numpy(pred), torch.from_numpy(target))
    want = np.asarray(jm.dice_coef(jnp.asarray(pred), jnp.asarray(target)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("weighted", [False, True])
def test_samplewise_f1_matches_jax(weighted):
    rng = np.random.default_rng(7)
    pred = (rng.random((6, 24, 24)) < 0.5).astype(np.float32)
    target = (rng.random((6, 24, 24)) < 0.4).astype(np.float32)
    pred[1] = 0.0
    target[1] = 0.0   # denominator 0 for class 1: scores 0
    target[2] = 0.0
    w = np.array([1, 1, 1, 1, 0, 0], np.float32) if weighted else None
    got = tm.samplewise_f1(torch.from_numpy(pred), torch.from_numpy(target),
                           None if w is None else torch.from_numpy(w))
    want = jm.samplewise_f1(jnp.asarray(pred), jnp.asarray(target),
                            None if w is None else jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def _rvs_case(kind, seed, n=4000):
    """Probabilities, 0/1 labels and an ROI: ``float`` scores are f32
    sigmoid-like values (few ties), ``ties`` take 21 distinct values,
    ``one_class`` has only background inside the ROI."""
    rng = np.random.default_rng(seed)
    labels = (rng.random(n) < 0.2).astype(np.float32)
    scores = np.clip(0.35 * labels + 0.65 * rng.random(n), 0, 1).astype(
        np.float32)
    if kind == "ties":
        scores = np.round(scores * 20) / 20
    roi = rng.random(n) < 0.7
    if kind == "one_class":
        roi &= labels == 0
    return scores.reshape(40, -1), labels.reshape(40, -1), roi.reshape(40, -1)


RVS_METRICS = ["auroc", "accuracy_score", "specificity", "sensitivity"]


@pytest.mark.parametrize("masked", [False, True], ids=["full", "roi"])
@pytest.mark.parametrize("kind", ["float", "ties", "one_class"])
@pytest.mark.parametrize("metric", RVS_METRICS)
def test_rvs_metrics_equal_jax(metric, kind, masked):
    scores, labels, roi = _rvs_case(kind, RVS_METRICS.index(metric))
    mask = roi if masked else None
    got = getattr(tm, metric)(scores, labels, mask)
    want = getattr(jm, metric)(scores, labels, mask)
    if metric == "auroc" and kind == "one_class" and masked:
        assert math.isnan(got) and math.isnan(want)
        return
    assert math.isfinite(got)
    assert got == pytest.approx(want, rel=0, abs=1e-12)


def test_auroc_ties_average_ranks():
    """Scores [.1, .4, .4, .8], labels [0, 1, 0, 1]: the tied pair shares
    rank 2.5, so AUROC = (2.5 + 4 - 3) / 4 = 0.875."""
    s = np.array([0.1, 0.4, 0.4, 0.8])
    y = np.array([0, 1, 0, 1])
    assert tm.auroc(s, y) == 0.875 == jm.auroc(s, y)
    assert math.isnan(tm.auroc(s, np.zeros(4)))
    assert tm.auroc(s, y, np.array([True, True, False, True])) == 1.0
