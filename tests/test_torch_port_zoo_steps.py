"""Zoo segmentors through the port's steps against the JAX steps, from the
same weights, batch and draws (replayed from the JAX key tree), f32 at
crop 64 with B=1 per domain and M=2: one search step and one autoaugment
train step (the augmented outcome of its coin) for

- ``lraspp``: ``experiments/zoo/lraspp_mnv3_optic.yaml`` with
  ``MODEL.BACKBONE mobilenet_v3_small`` on synthetic_optic;
- ``ocrnet``: ``experiments/zoo/ocrnet_hr18_rvs.yaml`` (HRNet-W18, FCN ->
  OCR cascade, one class) on synthetic_rvs from 128 x 128 pools, so the
  scale-crop draws scales in [0.5, 2] on both sides of 1; the
  HRNet is cut to one exchange unit per stage on both sides (the full
  depth only lengthens the JAX step's compile), widths unchanged.

The weights are numpy draws over the flax tree's shapes
(``test_torch_port_zoo.numpy_variables``). The port's heads apply the
classifier-dropout masks the JAX step drew from its dropout key: the FCN
stage's and, for OCRNet, the OCR head's.

Tolerances (those of ``test_torch_port_segformer_steps.py``): losses rtol
1e-4; rewards rtol 1e-3; dice atol 1e-3; BatchNorm statistics rtol/atol
2e-4; model gradients within 1e-3 of each tensor's largest magnitude, or
within 1e-6 of the model's largest gradient where a tensor's gradient
vanishes (``check_grads_floored``: a per-channel shift before a
train-mode BatchNorm, such as a MobileNetV3 block's ``project_bn`` bias
feeding the next block's expand conv, has gradient 0, and both frameworks
give rounding noise of up to 1.3e-7 of the largest gradient there);
discriminator gradients within 1e-3 of each tensor's largest magnitude.
OCRNet's model gradients are held by relative L2 instead (0.15 over the
model, 0.25 per tensor, ``check_grads(tight=False)``, as for the DeepLab
steps): through HRNet's train-mode BatchNorms they are f32-noisy in both
frameworks; on a forward and backward of this model the port in float64
differs from JAX by 0.4-1% of a tensor's largest gradient at the stem and
the FCN stage, and the port in f32 from the port in float64 by 0.3%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aadg_tpu.config import load_config as jax_load_config
from aadg_tpu.engine import state as jstate
from aadg_tpu.engine import steps as jsteps
from aadg_tpu.models.zoo import attention_heads as jah
from aadg_tpu.models.zoo import backbones as jbb
from aadg_tpu.models.zoo import heads as jheads
from aadg_tpu.models.zoo import segmentor as jseg
from aadg_tpu_torch.config import load_config
from aadg_tpu_torch.data.datasets import SyntheticDataset
from aadg_tpu_torch.engine import state as tstate
from aadg_tpu_torch.engine import steps as tsteps
from aadg_tpu_torch.models.zoo import attention_heads as tah
from aadg_tpu_torch.models.zoo import backbones as tbb
from aadg_tpu_torch.models.zoo import heads as theads
from aadg_tpu_torch.models.zoo import segmentor as tseg
from aadg_tpu_torch.ops.augment import PolicyDraw
from test_torch_port_zoo import jax_dropout_masks, numpy_variables
from torch_port_helpers import few_torch_threads  # noqa: F401
from torch_port_helpers import (M, _capture, check_grads,
                                check_grads_floored, check_metrics,
                                check_stats, crop_draw, policy_draws,
                                port_state, soft_label_draws, torch_batch)

N0 = 3  # B=1 x 3 domains
HR_WIRE = dict(in_index=(0, 1, 2, 3), input_transform="resize_concat")


def _cut_ocrnet():
    """(JAX, port) OCRNet over HRNet-W18 with one exchange unit per stage
    and one class, wired as ``build_segmentor`` wires it."""
    chans = [18, 36, 72, 144]
    jmodel = jseg.CascadeEncoderDecoder(
        backbone=jbb.HRNet(18, (1, 1, 1)),
        decode_head=jheads.FCNHead(1, channels=512, num_convs=1,
                                   concat_input=False, **HR_WIRE),
        cascade_heads=(jah.OCRHead(1, channels=512, ocr_channels=256,
                                   **HR_WIRE),), feat_ch=144)

    def tmodel():
        return tseg.CascadeEncoderDecoder(
            tbb.HRNet(18, (1, 1, 1)),
            theads.FCNHead(chans, 1, channels=512, num_convs=1,
                           concat_input=False, **HR_WIRE),
            (tah.OCRHead(chans, 1, channels=512, ocr_channels=256,
                         **HR_WIRE),), 144)
    return jmodel, tmodel


TASKS = {
    # name: (config, overrides, dataset, pool side, scale range, depth cut)
    "lraspp": ("experiments/zoo/lraspp_mnv3_optic.yaml",
               ["MODEL.BACKBONE", "mobilenet_v3_small"], "optic", 64,
               (1.0, 1.5), None),
    "ocrnet": ("experiments/zoo/ocrnet_hr18_rvs.yaml", [], "rvs", 128,
               (0.5, 2.0), _cut_ocrnet),
}


@pytest.fixture(scope="module", params=sorted(TASKS))
def pair(request):
    cfg, extra, dataset, side, scales, cut = TASKS[request.param]
    opts = ["DATASET.NAME", f"synthetic_{dataset}", "TPU.CROP_SIZE", "64",
            "TRAIN.BATCH_SIZE", "1", "CONTROLLER.M", str(M),
            "TRAIN.WD", "0.0001", *extra]
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
    ds = SyntheticDataset(dataset, n_per_domain=1, size=side)
    batch = (np.stack([d.images[0] for d in ds.domains])[None].astype(
                 np.float32),
             np.stack([d.labels[0] for d in ds.domains])[None].astype(
                 np.float32),
             np.arange(3, dtype=np.int32)[None])
    return request.param, jent, sd, tent, batch, scales, side


def _masks(jent, sd, n, key):
    variables = {"params": sd.seg_params, "batch_stats": sd.seg_stats}
    masks = jax_dropout_masks(jent.model, variables,
                              (jnp.zeros((n, 64, 64, 3)),), key)
    assert len(masks) in (1, 2) and not all(m.all() for m in masks)
    return tuple(masks)


def _policies(m, seed):
    rng = np.random.default_rng(seed)
    pol = np.stack([rng.integers(0, 10, (m, 5, 2)),
                    rng.integers(0, 10, (m, 5, 2))], -1).astype(np.int32)
    pol[:, :, 0, 0] = [0, 2, 0, 2, 0][:5]    # AutoContrast, Equalize: K2
    return pol


def _check_model(name, tsd, new_sd):
    if name == "ocrnet":
        check_grads(tsd.model, new_sd.seg_opt, tight=False)
    else:
        check_grads_floored(tsd.model, new_sd.seg_opt, floor=1e-6)
    check_stats(tsd.model, new_sd.seg_stats)


def test_zoo_search_step_matches_jax(pair):
    name, jent, sd, tent, batch, scales, side = pair
    policies = _policies(M, 0)
    key = jax.random.PRNGKey(12)
    new_sd, jm, jr = jax.jit(jsteps.make_search_step(jent, M))(
        sd, batch, policies, key)
    k_aug, k_t, k_d, k_drop = jax.random.split(key, 4)
    q, centre = policy_draws(jax.random.split(k_aug, N0), M, 5, 2, side,
                            side)
    draws = tsteps.SearchDraws(
        PolicyDraw(torch.from_numpy(q), torch.from_numpy(centre)),
        crop_draw(jax.random.split(k_t, N0 * M), scales),
        torch.from_numpy(soft_label_draws(jax.random.split(k_d, N0), 3)),
        _masks(jent, sd, N0 * M, k_drop))
    assert [m.shape[0] for m in draws.dropout] == [N0 * M] * len(
        draws.dropout)
    tsd = port_state(tent, sd)
    tm, tr = tsteps.make_search_step(tent, M)(
        tsd, torch_batch(batch), torch.from_numpy(policies.astype(np.int64)),
        draws)
    check_metrics(tm, jm)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-3,
                               atol=1e-6)
    _check_model(name, tsd, new_sd)
    check_grads(tsd.disc, new_sd.dis_opt, tight=True)


def test_zoo_autoaug_train_step_matches_jax(pair):
    name, jent, sd, tent, batch, scales, side = pair
    policies = _policies(1, 3)
    key = next(k for k in map(jax.random.PRNGKey, range(100))
               if float(jax.random.uniform(jax.random.split(k, 3)[0])) > 0.5)
    new_sd, jm = jax.jit(jsteps.make_autoaug_train_step(jent))(
        sd, batch, policies, key)
    k_coin, k_aug, k_rest = jax.random.split(key, 3)
    k_t, _, k_drop = jax.random.split(k_rest, 3)
    q, centre = policy_draws(jax.random.split(k_aug, N0), 1, 5, 2, side,
                            side)
    draws = tsteps.TrainDraws(
        torch.tensor(float(jax.random.uniform(k_coin))),
        PolicyDraw(torch.from_numpy(q), torch.from_numpy(centre)),
        crop_draw(jax.random.split(k_t, N0), scales),
        _masks(jent, sd, N0, k_drop))
    tsd = port_state(tent, sd)
    tm = tsteps.make_autoaug_train_step(tent)(
        tsd, torch_batch(batch), torch.from_numpy(policies.astype(np.int64)),
        draws)
    assert set(tm) == set(jm)
    np.testing.assert_allclose(float(tm["seg_loss"]), float(jm["seg_loss"]),
                               rtol=1e-4)
    _check_model(name, tsd, new_sd)
