"""The zoo over the port's new backbones through the port's steps against
the JAX steps, from the same weights (numpy draws over the flax tree's
shapes, ``test_torch_port_zoo.numpy_variables``), batch and draws
(replayed from the JAX key tree), f32 at crop 64 with B=1 per domain and
M=2 on ``experiments/zoo/pspnet_r50_optic.yaml`` and synthetic_optic: one
search step and one autoaugment train step (the augmented outcome of its
coin) of ``fcn/resnest50``, ``fast_scnn/fast_scnn`` and ``fcn/cgnet``
(CGNet cut to (3, 5) blocks on both sides, widths unchanged).

Tolerances of ``test_torch_port_zoo_steps.py``: losses rtol 1e-4; rewards
rtol 1e-3; dice atol 1e-3; BatchNorm statistics rtol/atol 2e-4;
discriminator gradients within 1e-3 of each tensor's largest magnitude;
model gradients by relative L2 (0.15 over the model, 0.25 per tensor,
``check_grads(tight=False)``, as for OCRNet and the DeepLab steps):
gradients through these deep train-mode BatchNorm stacks are f32-noisy
in both frameworks, most of all through split attention's BatchNorm over
the pooled vectors of 6 images.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aadg_tpu.config import load_config as jax_load_config
from aadg_tpu.engine import state as jstate
from aadg_tpu.engine import steps as jsteps
from aadg_tpu.models.zoo import backbones as jbb
from aadg_tpu.models.zoo import heads as jheads
from aadg_tpu.models.zoo import segmentor as jseg
from aadg_tpu_torch.config import load_config
from aadg_tpu_torch.data.datasets import SyntheticDataset
from aadg_tpu_torch.engine import state as tstate
from aadg_tpu_torch.engine import steps as tsteps
from aadg_tpu_torch.models.zoo import backbones as tbb
from aadg_tpu_torch.models.zoo import heads as theads
from aadg_tpu_torch.models.zoo import segmentor as tseg
from aadg_tpu_torch.ops.augment import PolicyDraw
from test_torch_port_zoo import numpy_variables
from test_torch_port_zoo_steps import N0, _masks, _policies
from torch_port_helpers import few_torch_threads  # noqa: F401
from torch_port_helpers import (M, _capture, check_grads, check_metrics,
                                check_stats, crop_draw, policy_draws,
                                port_state, soft_label_draws, torch_batch)

CG_CUT = dict(num_blocks=(3, 5))


def _cut_cgnet():
    """(JAX, port) FCN over CGNet cut to (3, 5) blocks, widths unchanged."""
    jmodel = jseg.EncoderDecoder(
        backbone=jbb.CGNet(**CG_CUT),
        decode_head=jheads.FCNHead(2, channels=512), feat_ch=256)

    def tmodel():
        return tseg.EncoderDecoder(
            tbb.CGNet(**CG_CUT),
            theads.FCNHead([35, 131, 256], 2, channels=512), 256)
    return jmodel, tmodel


STEP_PAIRS = {  # name: (MODEL.NAME, MODEL.BACKBONE, depth cut)
    "fcn_resnest50": ("fcn", "resnest50", None),
    "fast_scnn": ("fast_scnn", "fast_scnn", None),
    "fcn_cgnet": ("fcn", "cgnet", _cut_cgnet),
}


@pytest.fixture(scope="module", params=sorted(STEP_PAIRS))
def pair(request):
    arch, backbone, cut = STEP_PAIRS[request.param]
    cfg = "experiments/zoo/pspnet_r50_optic.yaml"
    opts = ["DATASET.NAME", "synthetic_optic", "TPU.CROP_SIZE", "64",
            "TRAIN.BATCH_SIZE", "1", "CONTROLLER.M", str(M),
            "MODEL.NAME", arch, "MODEL.BACKBONE", backbone]
    jent = jstate.build_entities(jax_load_config(cfg, opts), "search",
                                 steps_per_epoch=1)
    tent = tstate.build_entities(load_config(cfg, opts), "search",
                                 steps_per_epoch=1, device="cpu")
    if cut is not None:
        jmodel, tmodel = cut()
        assert type(jmodel) is type(jent.model)
        jent, tent = jent._replace(model=jmodel), tent._replace(
            make_model=tmodel)
    jent = jent._replace(model_tx=_capture(), dis_tx=_capture())
    variables = numpy_variables(jent.model, np.zeros((1, 64, 64, 3),
                                                     np.float32),
                                train=False, seed=1)
    dis_params = jent.disc.init(jax.random.PRNGKey(1),
                                jnp.zeros((1, jent.feature_dim)))["params"]
    sd = jstate.SegDisState(
        seg_params=variables["params"], seg_stats=variables["batch_stats"],
        seg_opt=jent.model_tx.init(variables["params"]),
        dis_params=dis_params, dis_stats={},
        dis_opt=jent.dis_tx.init(dis_params))
    ds = SyntheticDataset("optic", n_per_domain=1, size=64)
    batch = (np.stack([d.images[0] for d in ds.domains])[None].astype(
                 np.float32),
             np.stack([d.labels[0] for d in ds.domains])[None].astype(
                 np.float32),
             np.arange(3, dtype=np.int32)[None])
    return jent, sd, tent, batch


def test_new_backbone_search_step_matches_jax(pair):
    jent, sd, tent, batch = pair
    policies = _policies(M, 0)
    key = jax.random.PRNGKey(12)
    new_sd, jm, jr = jax.jit(jsteps.make_search_step(jent, M))(
        sd, batch, policies, key)
    k_aug, k_t, k_d, k_drop = jax.random.split(key, 4)
    q, centre = policy_draws(jax.random.split(k_aug, N0), M, 5, 2, 64, 64)
    draws = tsteps.SearchDraws(
        PolicyDraw(torch.from_numpy(q), torch.from_numpy(centre)),
        crop_draw(jax.random.split(k_t, N0 * M), (1.0, 1.5)),
        torch.from_numpy(soft_label_draws(jax.random.split(k_d, N0), 3)),
        _masks(jent, sd, N0 * M, k_drop))
    tsd = port_state(tent, sd)
    tm, tr = tsteps.make_search_step(tent, M)(
        tsd, torch_batch(batch), torch.from_numpy(policies.astype(np.int64)),
        draws)
    check_metrics(tm, jm)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-3,
                               atol=1e-6)
    check_grads(tsd.model, new_sd.seg_opt, tight=False)
    check_stats(tsd.model, new_sd.seg_stats)
    check_grads(tsd.disc, new_sd.dis_opt, tight=True)


def test_new_backbone_autoaug_train_step_matches_jax(pair):
    jent, sd, tent, batch = pair
    policies = _policies(1, 3)
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
        crop_draw(jax.random.split(k_t, N0), (1.0, 1.5)),
        _masks(jent, sd, N0, k_drop))
    tsd = port_state(tent, sd)
    tm = tsteps.make_autoaug_train_step(tent)(
        tsd, torch_batch(batch), torch.from_numpy(policies.astype(np.int64)),
        draws)
    assert set(tm) == set(jm)
    np.testing.assert_allclose(float(tm["seg_loss"]), float(jm["seg_loss"]),
                               rtol=1e-4)
    check_grads(tsd.model, new_sd.seg_opt, tight=False)
    check_stats(tsd.model, new_sd.seg_stats)
