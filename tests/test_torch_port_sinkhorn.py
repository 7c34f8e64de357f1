"""The port's Sinkhorn (K1's plain softmin and the batched divergences)
against the JAX package.

Tolerances: rtol 1e-5 / atol 1e-6. The port evaluates each softmin in the
Pallas kernel's form (z = log w + g/eps, then - cost/eps) where the dense
JAX path evaluates log w + (g - cost)/eps, so the two round differently in
the last bits of f32; 13 annealed iterations keep that at ~1e-7 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from aadg_tpu.ops import sinkhorn as jsk
from aadg_tpu.ops import sinkhorn_pallas as jskp
from aadg_tpu_torch.ops import sinkhorn as tsk
from torch_port_helpers import few_torch_threads  # noqa: F401


def _normalized(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_plain_softmin_vs_pallas_interpret():
    """N = M = 256 (one 256 block), D = 128, the last 56 rows/columns
    padded as sinkhorn_online pads them (zero rows, zb = -1e30)."""
    rng = np.random.default_rng(0)
    n = m = 256
    real = 200
    xn = _normalized(rng, n, 128)
    yn = _normalized(rng, m, 128)
    xn[real:] = 0.0
    yn[real:] = 0.0
    zb = (np.log(np.full(m, 1.0 / real, np.float32))
          + rng.normal(size=m).astype(np.float32) * 0.3).astype(np.float32)
    zb[real:] = -1e30
    eps = 0.05
    with pltpu.force_tpu_interpret_mode():
        j = np.asarray(jskp.softmin_online(jnp.float32(eps), jnp.asarray(xn),
                                           jnp.asarray(yn), jnp.asarray(zb),
                                           256, 256))
    t = tsk.softmin(eps, torch.from_numpy(xn)[None], torch.from_numpy(yn)[None],
                    torch.from_numpy(zb)[None])[0].numpy()
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)


def test_eps_schedule_equal():
    for args in [(2.0, 0.05, 0.5, 5), (2.0, 0.01, 0.7, 0), (1.0, 0.5, 0.5, 2)]:
        j = np.asarray(jsk._eps_schedule(*args))
        t = np.asarray(tsk._eps_schedule(*args), np.float32)
        np.testing.assert_array_equal(t, j)


def test_cosine_cost():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 16)).astype(np.float32)
    y = rng.normal(size=(2, 5, 16)).astype(np.float32)
    t = tsk.cosine_cost(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    for p in range(2):
        j = np.asarray(jsk.cosine_cost(jnp.asarray(x[p]), jnp.asarray(y[p])))
        np.testing.assert_allclose(t[p], j, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,m,weighted", [(8, 8, False), (5, 9, False),
                                          (6, 6, True)])
def test_sinkhorn_divergence_batched(n, m, weighted):
    rng = np.random.default_rng(2 + n + m)
    p = 3
    x = rng.normal(size=(p, n, 32)).astype(np.float32)
    y = (rng.normal(size=(p, m, 32)) + 0.4).astype(np.float32)
    wx = rng.uniform(0.5, 2.0, (p, n)).astype(np.float32) if weighted else None
    wy = rng.uniform(0.5, 2.0, (p, m)).astype(np.float32) if weighted else None
    t = tsk.sinkhorn_divergence(
        torch.from_numpy(x), torch.from_numpy(y),
        None if wx is None else torch.from_numpy(wx),
        None if wy is None else torch.from_numpy(wy)).numpy()
    j = np.array([float(jsk.sinkhorn_divergence(
        jnp.asarray(x[i]), jnp.asarray(y[i]),
        None if wx is None else jnp.asarray(wx[i]),
        None if wy is None else jnp.asarray(wy[i]))) for i in range(p)])
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)


def test_pairwise_domain_ot_rewards_shape():
    """The search step's reward call: features (M=2, D=3, B=8, F=128)."""
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(2, 3, 8, 128)).astype(np.float32)
    feats[:, 1] += 0.5
    t = tsk.pairwise_domain_ot(torch.from_numpy(feats)).numpy()
    j = np.array([float(jsk.pairwise_domain_ot(jnp.asarray(feats[i])))
                  for i in range(2)])
    assert t.shape == (2,)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)


def test_self_divergence_zero():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 8, 16)).astype(np.float32))
    np.testing.assert_allclose(tsk.sinkhorn_divergence(x, x).numpy(), 0.0,
                               atol=1e-5)


def test_softmin_wrapper_rejects_bad_input():
    x = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError):
        tsk.softmin(0.1, x, torch.zeros(1, 4, 7), torch.zeros(1, 4))
    with pytest.raises(ValueError):
        tsk.softmin(0.1, x.double(), x.double(), torch.zeros(1, 4))


def test_pairwise_domain_ot_full_reward_shape():
    """The search step's whole reward call: features (M=6, D=3, B=8,
    F=128), 18 divergences."""
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(6, 3, 8, 128)).astype(np.float32)
    feats[:, 2] += 0.3
    t = tsk.pairwise_domain_ot(torch.from_numpy(feats)).numpy()
    j = np.array([float(jsk.pairwise_domain_ot(jnp.asarray(feats[i])))
                  for i in range(6)])
    assert t.shape == (6,)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,m,weighted,debias", [(8, 8, False, True),
                                                 (8, 8, False, False),
                                                 (5, 9, True, True),
                                                 (7, 4, True, False)])
def test_sinkhorn_solve_plain_vs_jax(n, m, weighted, debias):
    """The plain version of the one-launch solve, on raw clouds of 128
    features, against the dense JAX divergence."""
    rng = np.random.default_rng(6 + n + m)
    p = 2
    x = rng.normal(size=(p, n, 128)).astype(np.float32)
    y = (rng.normal(size=(p, m, 128)) + 0.3).astype(np.float32)
    wx = rng.uniform(0.5, 2.0, (p, n)).astype(np.float32) if weighted else None
    wy = rng.uniform(0.5, 2.0, (p, m)).astype(np.float32) if weighted else None
    opt = lambda a: None if a is None else torch.from_numpy(a)
    t = tsk.sinkhorn_solve_plain(
        torch.from_numpy(x), torch.from_numpy(y),
        tsk._eps_schedule(2.0, 0.05, 0.5, 5), opt(wx), opt(wy),
        debias).numpy()
    j = np.array([float(jsk.sinkhorn_divergence(
        jnp.asarray(x[i]), jnp.asarray(y[i]),
        None if wx is None else jnp.asarray(wx[i]),
        None if wy is None else jnp.asarray(wy[i]), debias=debias))
        for i in range(p)])
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("device,n,m,d,route", [
    ("cpu", 8, 8, 128, "plain"),
    ("cpu", 4096, 4096, 128, "plain"),
    ("cuda", 8, 8, 128, "solve"),
    ("cuda", 5, 9, 3, "solve"),
    ("cuda", tsk.SOLVE_MAX_POINTS, tsk.SOLVE_MAX_POINTS, tsk.SOLVE_MAX_DIM,
     "solve"),
    ("cuda", tsk.SOLVE_MAX_POINTS + 1, 8, 128, "softmin"),
    ("cuda", 8, tsk.SOLVE_MAX_POINTS + 1, 128, "softmin"),
    ("cuda", 8, 8, tsk.SOLVE_MAX_DIM + 1, "softmin"),
    ("cuda", 512, 512, 128, "softmin")])
def test_divergence_route(device, n, m, d, route):
    assert tsk.divergence_route(device, n, m, d) == route


def test_solve_limits_fit_shared_memory():
    """The limits follow from one block's 227 KB: the largest cloud fits at
    the widest feature, one more point does not, and L=64 fits at D=128."""
    lim, dim = tsk.SOLVE_MAX_POINTS, tsk.SOLVE_MAX_DIM
    assert tsk.solve_smem_bytes(lim, lim, dim) <= tsk.SOLVE_SMEM_BYTES
    assert tsk.solve_smem_bytes(lim + 1, lim + 1, dim) > tsk.SOLVE_SMEM_BYTES
    assert lim >= 64
    assert tsk.solve_smem_bytes(64, 64, 128) <= tsk.SOLVE_SMEM_BYTES


def test_sinkhorn_solve_rejects_bad_input():
    eps = tsk._eps_schedule(2.0, 0.05, 0.5, 5)
    x = torch.zeros(2, 4, 8)
    lim = tsk.SOLVE_MAX_POINTS
    bad = [
        (x.double(), x.double(), None, None),                 # f64
        (x, x, torch.ones(2, 4, dtype=torch.float64), None),  # f64 weights
        (torch.zeros(2, 8, 4).transpose(1, 2), x, None, None),  # strided
        (x, x, torch.ones(4, 2).t(), None),                   # strided weights
        (x, torch.zeros(2, 4, 7), None, None),                # D mismatch
        (x, x, None, torch.ones(2, 5)),                       # weight shape
        (torch.zeros(1, lim + 1, 8), torch.zeros(1, 4, 8), None, None),
        (torch.zeros(1, 4, tsk.SOLVE_MAX_DIM + 1),
         torch.zeros(1, 4, tsk.SOLVE_MAX_DIM + 1), None, None),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            tsk.sinkhorn_solve(args[0], args[1], eps, args[2], args[3])
    with pytest.raises(ValueError):
        tsk.sinkhorn_solve(x, x, [])
