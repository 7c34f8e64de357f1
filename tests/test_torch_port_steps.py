"""One warmup step of the port against the JAX step,
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
import pytest
import torch

from aadg_tpu.engine import steps as jsteps
from aadg_tpu_torch.engine import steps as tsteps
from torch_port_helpers import few_torch_threads  # noqa: F401
from torch_port_helpers import (check_grads, check_metrics, check_stats,
                                crop_draw, port_state, soft_label_draws,
                                step_pair, torch_batch)


@pytest.fixture(scope="module")
def setup():
    return step_pair()


def test_pretrain_step_matches_jax(setup):
    jent, sd, tent, batch = setup
    key = jax.random.PRNGKey(11)
    new_sd, jm = jax.jit(jsteps.make_pretrain_step(jent))(sd, batch, key)
    k_t, k_d, _ = jax.random.split(key, 3)
    n0 = 3
    draws = tsteps.PretrainDraws(
        crop_draw(jax.random.split(k_t, n0)),
        torch.from_numpy(soft_label_draws(jax.random.split(k_d, n0), 3)))
    tsd = port_state(tent, sd)
    tm = tsteps.make_pretrain_step(tent)(tsd, torch_batch(batch), draws)
    check_metrics(tm, jm)
    check_grads(tsd.model, new_sd.seg_opt, tight=False)
    check_grads(tsd.disc, new_sd.dis_opt, tight=True)
    check_stats(tsd.model, new_sd.seg_stats)
