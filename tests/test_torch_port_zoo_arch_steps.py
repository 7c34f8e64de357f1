"""Slice 7's zoo cells through the port's steps against the JAX steps, from
the same weights, batch and draws (replayed from the JAX key tree), f32 at
crop 64 with B=1 per domain and M=2 on synthetic_optic: one search step
and one autoaugment train step (the augmented outcome of its coin) of
``experiments/zoo/pspnet_r50_optic.yaml`` with

- ``MODEL.NAME deeplabv3plus`` (separable ASPP and the stride-4 skip);
- ``MODEL.NAME emanet`` at ``TRAIN.WD 0.0004`` (EMA bases, whose update
  shows in the batch statistics, and ``ema_mid_conv``, which JAX's
  gradient leaves at exactly 0);
- ``MODEL.NAME pointrend`` (FPN neck, FPNHead; the search step trains
  the coarse head, then an eval forward of the updated statistics runs
  the subdivision refine; at crop 64 it re-scores every pixel of its
  32 x 32 and 64 x 64 maps, so no tie among uncertainties can pick
  different pixels);

each cut in depth by ``MODEL.BACKBONE mobilenet_v3_small`` (the full
ResNetV1c-50 only lengthens the JAX step's compile; the heads keep their
full widths). The weights are numpy draws over the flax tree's shapes
(``test_torch_port_zoo.numpy_variables``), and the port applies the
dropout masks the JAX step drew.

Tolerances (those of ``test_torch_port_zoo_steps.py``): losses rtol 1e-4;
rewards rtol 1e-3; dice atol 1e-3; BatchNorm statistics and EMA bases
rtol/atol 2e-4; discriminator gradients within 1e-3 of each tensor's
largest; the eval logits within rtol 1e-4 and atol 1e-4 of their largest.
Model gradients: ``emanet`` within 1e-3 of each tensor's largest
magnitude, or 1e-6 of the model's largest gradient where a tensor's
gradient vanishes; ``deeplabv3plus`` and ``pointrend`` by relative L2
over the model and for each tensor holding at least 1% of the largest
tensor's norm (``check_grads_l2``), at the limits of ``L2_LIMITS``, set
at about twice the gaps measured on an x86 CPU, port f32 against JAX f32
(model / worst tensor): deeplabv3plus search 0.51% / 1.0%, train 1.32%
/ 6.3% (the train step's BatchNorms see 3 crops: the SE block's fc1 of
the backbone's last stage); pointrend search 0.19% / 0.83%, train 0.25%
/ 0.43%. The gaps are f32 rounding: on a train forward and backward of
these two models (6 crops of 64, the same weights and masks) the port
in float64 is within 2.6e-8 (relative L2) of JAX in float64, while in
f32 JAX's gradients move by 0.59% (deeplabv3plus) and 0.09% (pointrend;
flax's BatchNorm takes the variance as E[x^2] - E[x]^2), the port's by
0.52% and 0.0004%.

Last, the optimizer: after two port search steps of ``emanet`` at
``TRAIN.WD 0.0004``, ``ema_mid_conv`` (no gradient) equals what JAX's own
optimizer (``aadg_tpu/engine/state.py::torch_adam``) makes of its initial
values with two zero gradients, within 1e-3 of its largest change: moved
by the decay through Adam, as optax updates every parameter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aadg_tpu.config import load_config as jax_load_config
from aadg_tpu.engine import state as jstate
from aadg_tpu.engine import steps as jsteps
from aadg_tpu_torch.config import load_config
from aadg_tpu_torch.data.datasets import SyntheticDataset
from aadg_tpu_torch.engine import state as tstate
from aadg_tpu_torch.engine import steps as tsteps
from aadg_tpu_torch.ops.augment import PolicyDraw
from aadg_tpu_torch.weights import from_flax
from test_torch_port_zoo import close, numpy_variables
from test_torch_port_zoo_steps import N0, _masks, _policies
from torch_port_helpers import few_torch_threads  # noqa: F401
from torch_port_helpers import (M, _capture, _np, check_grads_floored,
                                check_metrics, check_stats, crop_draw,
                                policy_draws, port_state, soft_label_draws,
                                torch_batch)

CFG = "experiments/zoo/pspnet_r50_optic.yaml"
WD = {"emanet": "0.0004"}
CELLS = ("deeplabv3plus", "emanet", "pointrend")
# (model, tensor) relative-L2 limits of the model gradients per cell and step
L2_LIMITS = {("deeplabv3plus", "search"): (0.01, 0.025),
             ("deeplabv3plus", "train"): (0.02, 0.10),
             ("pointrend", "search"): (0.005, 0.02),
             ("pointrend", "train"): (0.005, 0.02)}


def _opts(arch):
    return ["DATASET.NAME", "synthetic_optic", "TPU.CROP_SIZE", "64",
            "TRAIN.BATCH_SIZE", "1", "CONTROLLER.M", str(M),
            "MODEL.NAME", arch, "MODEL.BACKBONE", "mobilenet_v3_small",
            "TRAIN.WD", WD.get(arch, "0.0001")]


def _build(arch):
    jent = jstate.build_entities(jax_load_config(CFG, _opts(arch)),
                                 "search", steps_per_epoch=1)
    tent = tstate.build_entities(load_config(CFG, _opts(arch)), "search",
                                 steps_per_epoch=1, device="cpu")
    model_tx = jent.model_tx
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
    return arch, jent, sd, tent, batch, model_tx


@pytest.fixture(scope="module", params=CELLS)
def pair(request):
    return _build(request.param)


def check_grads_l2(module, jgrads, model_tol, tensor_tol):
    ref = from_flax({"params": _np(jgrads)})
    pairs = [(k, p.grad.numpy(), ref[k].numpy())
             for k, p in module.named_parameters()]
    assert sorted(k for k, _, _ in pairs) == sorted(ref)
    diff = np.sqrt(sum(np.sum((g - j) ** 2) for _, g, j in pairs))
    norm = np.sqrt(sum(np.sum(j ** 2) for _, _, j in pairs))
    assert diff <= model_tol * norm, diff / norm
    top = max(np.linalg.norm(j) for _, _, j in pairs)
    for k, g, j in pairs:
        if np.linalg.norm(j) >= 0.01 * top:
            assert np.linalg.norm(g - j) <= tensor_tol * np.linalg.norm(j), k


def _check_model(arch, step, tsd, new_sd):
    if arch == "emanet":
        check_grads_floored(tsd.model, new_sd.seg_opt, floor=1e-6)
    else:
        check_grads_l2(tsd.model, new_sd.seg_opt, *L2_LIMITS[arch, step])
    check_stats(tsd.model, new_sd.seg_stats)


def _search_draws(jent, sd, key):
    k_aug, k_t, k_d, k_drop = jax.random.split(key, 4)
    q, centre = policy_draws(jax.random.split(k_aug, N0), M, 5, 2, 64, 64)
    return tsteps.SearchDraws(
        PolicyDraw(torch.from_numpy(q), torch.from_numpy(centre)),
        crop_draw(jax.random.split(k_t, N0 * M)),
        torch.from_numpy(soft_label_draws(jax.random.split(k_d, N0), 3)),
        _masks(jent, sd, N0 * M, k_drop))


def test_zoo_arch_search_step_matches_jax(pair):
    arch, jent, sd, tent, batch, _ = pair
    policies = _policies(M, 0)
    key = jax.random.PRNGKey(12)
    new_sd, jm, jr = jax.jit(jsteps.make_search_step(jent, M))(
        sd, batch, policies, key)
    tsd = port_state(tent, sd)
    tm, tr = tsteps.make_search_step(tent, M)(
        tsd, torch_batch(batch), torch.from_numpy(policies.astype(np.int64)),
        _search_draws(jent, sd, key))
    check_metrics(tm, jm)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-3,
                               atol=1e-6)
    _check_model(arch, "search", tsd, new_sd)
    if arch == "emanet":
        grads = _np(new_sd.seg_opt)["decode_head"]["ema_mid_conv"]
        assert not any(np.any(g) for g in grads.values())
        assert not np.allclose(np.asarray(new_sd.seg_stats["decode_head"]
                                          ["bases"]),
                               np.asarray(sd.seg_stats["decode_head"]
                                          ["bases"]))
    if arch == "pointrend":
        # the eval forward of the updated statistics runs the refine
        variables = {"params": sd.seg_params,
                     "batch_stats": new_sd.seg_stats}
        x = np.random.default_rng(5).normal(size=(2, 64, 64, 3)).astype(
            np.float32)
        want, _ = jax.jit(lambda v, a: jent.model.apply(v, a, train=False))(
            variables, jnp.asarray(x))
        model = tent.make_model()
        model.load_state_dict(from_flax(_np(variables)), strict=True)
        with torch.no_grad():
            got, _ = model.eval()(torch.from_numpy(x))
        close(got, want)


def test_zoo_arch_autoaug_train_step_matches_jax(pair):
    arch, jent, sd, tent, batch, _ = pair
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
        crop_draw(jax.random.split(k_t, N0)), _masks(jent, sd, N0, k_drop))
    tsd = port_state(tent, sd)
    tm = tsteps.make_autoaug_train_step(tent)(
        tsd, torch_batch(batch), torch.from_numpy(policies.astype(np.int64)),
        draws)
    assert set(tm) == set(jm)
    np.testing.assert_allclose(float(tm["seg_loss"]), float(jm["seg_loss"]),
                               rtol=1e-4)
    _check_model(arch, "train", tsd, new_sd)


def test_no_gradient_parameter_steps_as_optax():
    _, jent, sd, tent, batch, model_tx = _build("emanet")
    tsd = port_state(tent, sd)
    step = tsteps.make_search_step(tent, M)
    policies = torch.from_numpy(_policies(M, 0).astype(np.int64))
    for seed in (12, 13):
        step(tsd, torch_batch(batch), policies,
             _search_draws(jent, sd, jax.random.PRNGKey(seed)))
    head = sd.seg_params["decode_head"]
    p0 = {"ema_mid_conv": head["ema_mid_conv"]}
    opt = model_tx.init(p0)
    zero = jax.tree_util.tree_map(jnp.zeros_like, p0)
    p = p0
    for _ in range(2):
        upd, opt = model_tx.update(zero, opt, p)
        p = optax.apply_updates(p, upd)
    want = from_flax({"params": _np(p)})
    start = from_flax({"params": _np(p0)})
    got = dict(tsd.model.decode_head.named_parameters())
    for k, v in want.items():
        moved = np.abs(v.numpy() - start[k].numpy()).max()
        assert moved > 0, k
        np.testing.assert_allclose(got[k].detach().numpy(), v.numpy(),
                                   rtol=0, atol=1e-3 * moved, err_msg=k)
