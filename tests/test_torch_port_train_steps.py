"""The train mode's steps of the port against the JAX steps, from the same
weights, batch and draws (replayed from the JAX key tree), in f32 at crop
64 with B=1 per domain: ``make_autoaug_train_step`` once for each outcome
of its coin, ``make_pretrain_step(step_disc=False)``, and the cosine
schedule of the train mode (equal to JAX's f32 values within f32
rounding: rtol 1e-6, and 1e-6 of the base rate near zero).

Tolerances are those of ``test_torch_port_steps.py``: losses rtol 1e-4, BN
statistics rtol/atol 2e-4, dice atol 1e-3, model gradients by relative L2
(0.15 over the model, 0.25 per tensor; train-mode BatchNorm at init makes
them f32-noisy in both frameworks). The discriminator must stay untouched.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aadg_tpu.engine import state as jstate
from aadg_tpu.engine import steps as jsteps
from aadg_tpu_torch.config import load_config
from aadg_tpu_torch.engine import state as tstate
from aadg_tpu_torch.engine import steps as tsteps
from aadg_tpu_torch.ops.augment import PolicyDraw
from torch_port_helpers import few_torch_threads  # noqa: F401
from torch_port_helpers import (CFG, OPTS, check_grads, check_stats, crop_draw,
                                policy_draws, port_state, soft_label_draws,
                                step_pair, torch_batch)

N0 = 3  # B=1 x 3 domains


@pytest.fixture(scope="module")
def setup():
    return step_pair()


@pytest.fixture(scope="module")
def autoaug_step(setup):
    return jax.jit(jsteps.make_autoaug_train_step(setup[0]))


def _policy():
    """A fixed (1, Q=5, L=2, 2) policy whose every sub-policy starts with
    a histogram op (AutoContrast or Equalize, the ops that reach K2)."""
    rng = np.random.default_rng(3)
    pol = np.stack([rng.integers(0, 10, (1, 5, 2)),
                    rng.integers(0, 10, (1, 5, 2))], -1).astype(np.int32)
    pol[0, :, 0, 0] = [0, 2, 0, 2, 0]
    return pol


def _key_with_coin(heads: bool):
    """The first PRNGKey(i) whose autoaug coin lands on ``heads``."""
    for i in range(100):
        key = jax.random.PRNGKey(i)
        coin = float(jax.random.uniform(jax.random.split(key, 3)[0]))
        if (coin > 0.5) == heads:
            return key, coin
    raise AssertionError("no key found")


def _disc_snapshot(tsd):
    return {k: v.clone() for k, v in tsd.disc.state_dict().items()}


def _check_disc_untouched(tsd, before, new_sd, sd):
    for k, v in tsd.disc.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(p.grad is None for p in tsd.disc.parameters())
    assert tsd.dis_opt.count == 0 and not tsd.dis_opt.opt.state
    jax.tree_util.tree_map(np.testing.assert_array_equal, new_sd.dis_params,
                           sd.dis_params)


def _check(tm, jm, tsd, new_sd):
    assert set(tm) == set(jm) == {"seg_loss", "cup_dsc", "disc_dsc"}
    np.testing.assert_allclose(float(tm["seg_loss"]), float(jm["seg_loss"]),
                               rtol=1e-4)
    for k in ("cup_dsc", "disc_dsc"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-3)
    check_grads(tsd.model, new_sd.seg_opt, tight=False)
    check_stats(tsd.model, new_sd.seg_stats)


@pytest.mark.parametrize("heads", [True, False],
                         ids=["augmented", "raw"])
def test_autoaug_train_step_matches_jax(setup, autoaug_step, heads):
    jent, sd, tent, batch = setup
    policies = _policy()
    key, coin = _key_with_coin(heads)
    new_sd, jm = autoaug_step(sd, batch, policies, key)
    k_coin, k_aug, k_rest = jax.random.split(key, 3)
    k_t = jax.random.split(k_rest, 3)[0]
    q, centre = policy_draws(jax.random.split(k_aug, N0), 1, 5, 2, 64, 64)
    draws = tsteps.TrainDraws(
        torch.tensor(coin, dtype=torch.float32),
        PolicyDraw(torch.from_numpy(q), torch.from_numpy(centre)),
        crop_draw(jax.random.split(k_t, N0)))
    tsd = port_state(tent, sd)
    before = _disc_snapshot(tsd)
    tm = tsteps.make_autoaug_train_step(tent)(
        tsd, torch_batch(batch), torch.from_numpy(policies.astype(np.int64)),
        draws)
    _check(tm, jm, tsd, new_sd)
    _check_disc_untouched(tsd, before, new_sd, sd)
    assert tsd.seg_opt.count == 1


def test_autoaug_coin_selects_the_batch(setup):
    """The coin alone picks augmented or raw: with the same draws, the raw
    outcome is the plain train step on the raw batch."""
    _, sd, tent, batch = setup
    policies = torch.from_numpy(_policy().astype(np.int64))
    gen = torch.Generator().manual_seed(5)
    draws = tsteps.draw_train(tent, N0, 64, 64, gen)
    assert draws.coin.shape == () and draws.policy.q.shape == (N0, 1)
    out = {}
    for name, coin, fn in (
            ("aug", 0.75, tsteps.make_autoaug_train_step(tent)),
            ("raw", 0.25, tsteps.make_autoaug_train_step(tent)),
            ("plain", None, tsteps.make_pretrain_step(tent,
                                                      step_disc=False))):
        tsd = port_state(tent, sd)
        if coin is None:
            ms = fn(tsd, torch_batch(batch), draws)
        else:
            ms = fn(tsd, torch_batch(batch), policies,
                    draws._replace(coin=torch.tensor(coin)))
        out[name] = float(ms["seg_loss"])
    assert out["raw"] == out["plain"]
    assert out["aug"] != out["raw"]


def test_pretrain_step_without_disc_matches_jax(setup):
    jent, sd, tent, batch = setup
    key = jax.random.PRNGKey(21)
    new_sd, jm = jax.jit(jsteps.make_pretrain_step(jent, step_disc=False))(
        sd, batch, key)
    k_t, k_d, _ = jax.random.split(key, 3)
    draws = tsteps.PretrainDraws(
        crop_draw(jax.random.split(k_t, N0)),
        torch.from_numpy(soft_label_draws(jax.random.split(k_d, N0), 3)))
    tsd = port_state(tent, sd)
    before = _disc_snapshot(tsd)
    tm = tsteps.make_pretrain_step(tent, step_disc=False)(
        tsd, torch_batch(batch), draws)
    _check(tm, jm, tsd, new_sd)
    _check_disc_untouched(tsd, before, new_sd, sd)


@pytest.mark.parametrize("total", [1, 7, 40])
def test_cosine_schedule_equals_jax(total):
    want = jstate.cosine_schedule(1e-3, total)
    got = tstate.cosine_schedule(1e-3, total)
    steps = sorted({0, 1, total // 2, total, total + 1, 3 * total})
    for s in steps:
        np.testing.assert_allclose(got(s), float(want(jnp.int32(s))),
                                   rtol=1e-6, atol=1e-9, err_msg=str(s))
    assert got(0) == 1e-3 and got(total) == 0.0 == got(total + 5)


def test_train_entities_use_cosine():
    cfg = load_config(CFG, OPTS + ["TRAIN.END_EPOCH", "4"])
    ent = tstate.build_entities(cfg, "train", steps_per_epoch=5,
                                device="cpu")
    want = jstate.cosine_schedule(float(cfg.TRAIN.LR), 20)
    for s in (0, 3, 10, 19, 20, 25):
        np.testing.assert_allclose(ent.model_schedule(s),
                                   float(want(jnp.int32(s))), rtol=1e-6,
                                   atol=1e-6 * float(cfg.TRAIN.LR))
    search = tstate.build_entities(cfg, "search", steps_per_epoch=5,
                                   device="cpu")
    assert search.model_schedule(0) == float(cfg.TRAIN.LR)
