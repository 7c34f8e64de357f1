"""One search step of the port against the JAX step,
from the same weights, batch and draws (replayed from the JAX key tree),
in f32 at crop 64 with B=1 per domain and M=2.

Tolerances: losses rtol 1e-4; rewards rtol 1e-3 (Sinkhorn on 128-d features
that carry the models' ~1e-4 differences); BN statistics rtol/atol 2e-4;
dice atol 1e-3 (a thresholded count can flip one pixel); discriminator
gradients within 1e-3 of each tensor's largest magnitude.

Segmentation-model gradients are compared by relative L2 error: 0.15 over
the whole model and 0.25 per tensor (tensors above 1% of the largest
gradient norm). Train-mode BatchNorm at initialization makes these
gradients ill-conditioned in f32: measured on this step, the port's f32
gradient is 4.3% (L2) from its own float64 gradient, the JAX step's 5.0%,
and the two are 6.2% apart, which is what independent f32 noise of those
sizes gives. With BatchNorm in eval mode the same f32/f64 gap is 5e-7. A
wrong mapping, sign or missing term shows as an O(1) error.
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


@pytest.fixture(scope="module")
def setup():
    return step_pair()


def test_search_step_matches_jax(setup):
    jent, sd, tent, batch = setup
    rng = np.random.default_rng(0)
    policies = np.stack([rng.integers(0, 10, (M, 5, 2)),
                         rng.integers(0, 10, (M, 5, 2))], -1).astype(np.int32)
    key = jax.random.PRNGKey(12)
    new_sd, jm, jr = jax.jit(jsteps.make_search_step(jent, M))(
        sd, batch, policies, key)
    k_aug, k_t, k_d, _ = jax.random.split(key, 4)
    n0 = 3
    q, centre = policy_draws(jax.random.split(k_aug, n0), M, 5, 2, 64, 64)
    draws = tsteps.SearchDraws(
        PolicyDraw(torch.from_numpy(q), torch.from_numpy(centre)),
        crop_draw(jax.random.split(k_t, n0 * M)),
        torch.from_numpy(soft_label_draws(jax.random.split(k_d, n0), 3)))
    tsd = port_state(tent, sd)
    tm, tr = tsteps.make_search_step(tent, M)(
        tsd, torch_batch(batch), torch.from_numpy(policies.astype(np.int64)),
        draws)
    check_metrics(tm, jm)
    assert tr.shape == (M,)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-3,
                               atol=1e-6)
    np.testing.assert_allclose(float(tm["diversity_ot"]),
                               float(jm["diversity_ot"]), rtol=1e-3)
    check_grads(tsd.model, new_sd.seg_opt, tight=False)
    check_grads(tsd.disc, new_sd.dis_opt, tight=True)
    check_stats(tsd.model, new_sd.seg_stats)
