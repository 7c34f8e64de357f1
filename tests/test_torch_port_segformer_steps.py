"""SegFormer through the port's steps against the JAX steps: one warmup
(pretrain) step, one search step and one autoaugment train step (the
augmented outcome of its coin), from the same weights, batch and draws,
in f32 at crop 64 with B=1 per domain and M=2. The config is
``experiments/zoo/segformer_b4_optic.yaml`` cut to MiT-b0 with stochastic
depth 0.5 (``torch_port_helpers.SEG_OPTS``); the port's model runs with
``TPU.REMAT`` on, the JAX model without, and the port applies the
dropout masks the JAX step drew from its dropout key
(``torch_port_helpers.dropout_draws``).

Tolerances: losses rtol 1e-4; rewards rtol 1e-3 (Sinkhorn on 128-d
features that carry the models' small differences); the head's BatchNorm
statistics rtol/atol 2e-4; dice atol 1e-3; segmentation-model gradients
within 1e-3 of each tensor's largest magnitude (or 1e-7 of the largest
gradient where a tensor's gradient vanishes, ``check_grads_floored``);
discriminator gradients within 1e-3 of each tensor's largest magnitude.
"""

import jax
import numpy as np
import pytest
import torch

from aadg_tpu.engine import steps as jsteps
from aadg_tpu_torch.engine import steps as tsteps
from aadg_tpu_torch.ops.augment import PolicyDraw
from torch_port_helpers import few_torch_threads  # noqa: F401
from torch_port_helpers import (M, check_grads, check_grads_floored,
                                check_metrics, check_stats, crop_draw,
                                dropout_draws, policy_draws, port_state,
                                soft_label_draws, step_pair, torch_batch,
                                torch_dropout)

N0 = 3  # B=1 x 3 domains


@pytest.fixture(scope="module")
def setup():
    return step_pair("segformer")


def _masks(jent, sd, n, key):
    variables = {"params": sd.seg_params, "batch_stats": sd.seg_stats}
    draws = dropout_draws(jent.model, variables, (n, 64, 64, 3), key)
    assert not draws.paths.all()
    return torch_dropout(draws)


def _check(tsd, tm, jm, new_sd, disc: bool = True):
    check_metrics(tm, jm) if disc else np.testing.assert_allclose(
        float(tm["seg_loss"]), float(jm["seg_loss"]), rtol=1e-4)
    check_grads_floored(tsd.model, new_sd.seg_opt)
    if disc:
        check_grads(tsd.disc, new_sd.dis_opt, tight=True)
    check_stats(tsd.model, new_sd.seg_stats)


def test_pretrain_step_matches_jax(setup):
    jent, sd, tent, batch = setup
    key = jax.random.PRNGKey(11)
    new_sd, jm = jax.jit(jsteps.make_pretrain_step(jent))(sd, batch, key)
    k_t, k_d, k_drop = jax.random.split(key, 3)
    draws = tsteps.PretrainDraws(
        crop_draw(jax.random.split(k_t, N0)),
        torch.from_numpy(soft_label_draws(jax.random.split(k_d, N0), 3)),
        _masks(jent, sd, N0, k_drop))
    tsd = port_state(tent, sd)
    assert tsd.model.backbone.remat
    tm = tsteps.make_pretrain_step(tent)(tsd, torch_batch(batch), draws)
    _check(tsd, tm, jm, new_sd)


def test_search_step_matches_jax(setup):
    jent, sd, tent, batch = setup
    rng = np.random.default_rng(0)
    policies = np.stack([rng.integers(0, 10, (M, 5, 2)),
                         rng.integers(0, 10, (M, 5, 2))], -1).astype(np.int32)
    key = jax.random.PRNGKey(12)
    new_sd, jm, jr = jax.jit(jsteps.make_search_step(jent, M))(
        sd, batch, policies, key)
    k_aug, k_t, k_d, k_drop = jax.random.split(key, 4)
    q, centre = policy_draws(jax.random.split(k_aug, N0), M, 5, 2, 64, 64)
    draws = tsteps.SearchDraws(
        PolicyDraw(torch.from_numpy(q), torch.from_numpy(centre)),
        crop_draw(jax.random.split(k_t, N0 * M)),
        torch.from_numpy(soft_label_draws(jax.random.split(k_d, N0), 3)),
        _masks(jent, sd, N0 * M, k_drop))
    tsd = port_state(tent, sd)
    tm, tr = tsteps.make_search_step(tent, M)(
        tsd, torch_batch(batch), torch.from_numpy(policies.astype(np.int64)),
        draws)
    assert tr.shape == (M,)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-3,
                               atol=1e-6)
    _check(tsd, tm, jm, new_sd)


def test_autoaug_train_step_matches_jax(setup):
    jent, sd, tent, batch = setup
    rng = np.random.default_rng(3)
    policies = np.stack([rng.integers(0, 10, (1, 5, 2)),
                         rng.integers(0, 10, (1, 5, 2))], -1).astype(np.int32)
    policies[0, :, 0, 0] = [0, 2, 0, 2, 0]   # AutoContrast, Equalize: K2
    key = next(k for k in map(jax.random.PRNGKey, range(100))
               if float(jax.random.uniform(jax.random.split(k, 3)[0])) > 0.5)
    new_sd, jm = jax.jit(jsteps.make_autoaug_train_step(jent))(
        sd, batch, policies, key)
    k_coin, k_aug, k_rest = jax.random.split(key, 3)
    k_t, _, k_drop = jax.random.split(k_rest, 3)
    q, centre = policy_draws(jax.random.split(k_aug, N0), 1, 5, 2, 64, 64)
    draws = tsteps.TrainDraws(
        torch.tensor(float(jax.random.uniform(k_coin))),
        PolicyDraw(torch.from_numpy(q), torch.from_numpy(centre)),
        crop_draw(jax.random.split(k_t, N0)),
        _masks(jent, sd, N0, k_drop))
    tsd = port_state(tent, sd)
    tm = tsteps.make_autoaug_train_step(tent)(
        tsd, torch_batch(batch), torch.from_numpy(policies.astype(np.int64)),
        draws)
    assert set(tm) == set(jm) == {"seg_loss", "cup_dsc", "disc_dsc"}
    _check(tsd, tm, jm, new_sd, disc=False)
