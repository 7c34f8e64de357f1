"""The rvs task's steps of the port against the JAX steps, from the same
weights, batch and draws (replayed from the JAX key tree): the flagship rvs
config (DeepLabV3+/MobileNetV2 with one output class) in f32 at crop 32
from 64² vessel pools, B=1 per domain, M=2. The scale-crop draws scales in
[0.5, 2], so the downscale (antialiased) branch of the resample runs.

One search step and one autoaugment train step (augmented coin). The
tolerances are those of ``test_torch_port_search_step.py``: losses rtol
1e-4, rewards rtol 1e-3, dice atol 1e-3, BN statistics rtol/atol 2e-4,
discriminator gradients within 1e-3 of each tensor's largest magnitude,
model gradients by relative L2 (0.15 over the model, 0.25 per tensor:
train-mode BatchNorm at init makes them f32-noisy in both frameworks).
"""

import jax
import numpy as np
import pytest
import torch

from aadg_tpu.engine import steps as jsteps
from aadg_tpu_torch.engine import steps as tsteps
from aadg_tpu_torch.ops.augment import PolicyDraw
from torch_port_helpers import few_torch_threads  # noqa: F401
from torch_port_helpers import (M, check_grads, check_metrics, check_stats,
                                crop_draw, policy_draws, port_state,
                                soft_label_draws, step_pair, torch_batch)

N0 = 3  # B=1 x 3 domains
RVS_SCALES = (0.5, 2.0)


@pytest.fixture(scope="module")
def setup():
    return step_pair("rvs")


def _policies(m):
    """(m, Q=5, L=2, 2) policies whose sub-policies start with a histogram
    op (AutoContrast or Equalize, the ops that reach K2)."""
    rng = np.random.default_rng(7)
    pol = np.stack([rng.integers(0, 10, (m, 5, 2)),
                    rng.integers(0, 10, (m, 5, 2))], -1).astype(np.int32)
    pol[:, :, 0, 0] = [0, 2, 0, 2, 0]
    return pol


def test_rvs_entities(setup):
    jent, _, tent, batch = setup
    assert tent.num_classes == jent.num_classes == 1
    assert tent.dataset_name == jent.dataset_name == "rvs"
    assert tent.feature_dim == jent.feature_dim == 1280
    assert tent.scale_range == RVS_SCALES
    assert batch[0].shape == (1, 3, 64, 64, 3)
    assert set(np.unique(batch[1])) == {0.0, 255.0}


def test_rvs_search_step_matches_jax(setup):
    jent, sd, tent, batch = setup
    policies = _policies(M)
    key = jax.random.PRNGKey(14)
    new_sd, jm, jr = jax.jit(jsteps.make_search_step(jent, M))(
        sd, batch, policies, key)
    k_aug, k_t, k_d, _ = jax.random.split(key, 4)
    q, centre = policy_draws(jax.random.split(k_aug, N0), M, 5, 2, 64, 64)
    crop = crop_draw(jax.random.split(k_t, N0 * M), RVS_SCALES)
    # the draws reach both sides of scale 1
    scales = torch.cat([crop.sw, crop.sh])
    assert float(scales.min()) < 1.0 < float(scales.max())
    draws = tsteps.SearchDraws(
        PolicyDraw(torch.from_numpy(q), torch.from_numpy(centre)), crop,
        torch.from_numpy(soft_label_draws(jax.random.split(k_d, N0), 3)))
    tsd = port_state(tent, sd)
    tm, tr = tsteps.make_search_step(tent, M)(
        tsd, torch_batch(batch), torch.from_numpy(policies.astype(np.int64)),
        draws)
    check_metrics(tm, jm)
    assert "dsc" in tm and "cup_dsc" not in tm
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-3,
                               atol=1e-6)
    check_grads(tsd.model, new_sd.seg_opt, tight=False)
    check_grads(tsd.disc, new_sd.dis_opt, tight=True)
    check_stats(tsd.model, new_sd.seg_stats)


def test_rvs_autoaug_train_step_matches_jax(setup):
    jent, sd, tent, batch = setup
    policies = _policies(1)
    for i in range(100):  # the first key whose coin picks the augmented batch
        key = jax.random.PRNGKey(i)
        coin = float(jax.random.uniform(jax.random.split(key, 3)[0]))
        if coin > 0.5:
            break
    new_sd, jm = jax.jit(jsteps.make_autoaug_train_step(jent))(
        sd, batch, policies, key)
    _, k_aug, k_rest = jax.random.split(key, 3)
    k_t = jax.random.split(k_rest, 3)[0]
    q, centre = policy_draws(jax.random.split(k_aug, N0), 1, 5, 2, 64, 64)
    draws = tsteps.TrainDraws(
        torch.tensor(coin, dtype=torch.float32),
        PolicyDraw(torch.from_numpy(q), torch.from_numpy(centre)),
        crop_draw(jax.random.split(k_t, N0), RVS_SCALES))
    tsd = port_state(tent, sd)
    tm = tsteps.make_autoaug_train_step(tent)(
        tsd, torch_batch(batch), torch.from_numpy(policies.astype(np.int64)),
        draws)
    assert set(tm) == set(jm) == {"seg_loss", "dsc"}
    np.testing.assert_allclose(float(tm["seg_loss"]), float(jm["seg_loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(tm["dsc"]), float(jm["dsc"]), atol=1e-3)
    check_grads(tsd.model, new_sd.seg_opt, tight=False)
    check_stats(tsd.model, new_sd.seg_stats)
