"""The port's models, loaded through ``weights.from_flax``, against the JAX
models on the same inputs.

DeepLabV3+/MobileNetV2 at 2 x 64 x 64 in f32, train and eval mode: pooled
feature and updated BN statistics within rtol/atol 2e-4, logits within
rtol/atol 1e-3. The logits' bound covers the reference's own f32 error:
measured against the same network in float64, the JAX model's logits are
off by up to 5.4e-4 (values up to 2.2), the port's by 1.8e-4; two f32
stacks of ~60 convolutions summing in different orders.
Discriminator: rtol 1e-5. Controller: rtol 1e-5. Bilinear x4 upsampling:
atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aadg_tpu.models import controller as jctrl
from aadg_tpu.models import discriminator as jdisc
from aadg_tpu.models.deeplab import DeepLabV3Plus as JDeepLab
from aadg_tpu_torch.models import controller as tctrl
from aadg_tpu_torch.models import discriminator as tdisc
from aadg_tpu_torch.models.deeplab import DeepLabV3Plus
from aadg_tpu_torch.weights import controller_from_jax, from_flax
from torch_port_helpers import few_torch_threads  # noqa: F401

TOL = dict(rtol=2e-4, atol=2e-4)
TOL_LOGITS = dict(rtol=1e-3, atol=1e-3)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


@pytest.fixture(scope="module")
def deeplab_pair():
    """A JAX DeepLabV3+ with perturbed BN parameters and statistics, and the
    port's model loaded from the same numbers."""
    jmodel = JDeepLab(num_classes=2, compute_dtype=jnp.float32)
    variables = jax.jit(lambda k: jmodel.init(
        k, jnp.zeros((1, 64, 64, 3)), train=False))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def perturb(path, a):
        name = path[-1].key
        if name in ("scale", "var"):
            return rng.uniform(0.8, 1.2, a.shape).astype(np.float32)
        if name in ("mean",) or (name == "bias" and a.ndim == 1
                                 and "Conv" not in str(path)):
            return rng.normal(0, 0.05, a.shape).astype(np.float32)
        return a

    params = jax.tree_util.tree_map_with_path(
        perturb, _np_tree(variables["params"]))
    stats = jax.tree_util.tree_map_with_path(
        perturb, _np_tree(variables["batch_stats"]))
    tmodel = DeepLabV3Plus(2)
    tmodel.load_state_dict(from_flax({"params": params, "batch_stats": stats}),
                          strict=True)
    return jmodel, params, stats, tmodel


def test_deeplab_train_mode_parity(deeplab_pair):
    jmodel, params, stats, tmodel = deeplab_pair
    x = np.random.default_rng(1).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    (jl, jf), upd = jax.jit(lambda p, s, x: jmodel.apply(
        {"params": p, "batch_stats": s}, x, train=True,
        mutable=["batch_stats"]))(params, stats, x)
    tmodel.train()
    tl, tf = tmodel(torch.from_numpy(x))
    assert tl.shape == (2, 64, 64, 2) and tf.shape == (2, 1280)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               **TOL_LOGITS)
    np.testing.assert_allclose(tf.detach().numpy(), np.asarray(jf), **TOL)
    new_stats = from_flax({"batch_stats": _np_tree(upd["batch_stats"])})
    sd = tmodel.state_dict()
    for k, v in new_stats.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), **TOL,
                                   err_msg=k)
    tmodel.load_state_dict(from_flax({"params": params,
                                     "batch_stats": stats}))  # for eval


def test_deeplab_eval_mode_parity(deeplab_pair):
    jmodel, params, stats, tmodel = deeplab_pair
    x = np.random.default_rng(2).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    jl, jf = jax.jit(lambda p, s, x: jmodel.apply(
        {"params": p, "batch_stats": s}, x, train=False))(params, stats, x)
    tmodel.eval()
    with torch.no_grad():
        tl, tf = tmodel(torch.from_numpy(x))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL_LOGITS)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **TOL)


@pytest.mark.parametrize("size", [(4, 4), (5, 7)])
def test_bilinear_x4_matches_jax_resize(size):
    import torch.nn.functional as F
    h, w = size
    y = np.random.default_rng(3).normal(size=(2, h, w, 6)).astype(np.float32)
    j = np.asarray(jax.image.resize(y, (2, 4 * h, 4 * w, 6), "bilinear"))
    t = F.interpolate(torch.from_numpy(y).permute(0, 3, 1, 2),
                      size=(4 * h, 4 * w), mode="bilinear",
                      align_corners=False).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-5)


def test_discriminator_both_branches_and_ema():
    jmodel = jdisc.MomentumFeatureDiscriminator(3, 64)
    params = _np_tree(jmodel.init(jax.random.PRNGKey(1),
                                  jnp.zeros((1, 64)))["params"])
    params["momentum"] = jax.tree_util.tree_map(
        lambda a: a + np.float32(0.01), params["momentum"])
    tmodel = tdisc.MomentumFeatureDiscriminator(3, 64)
    tmodel.load_state_dict(from_flax({"params": params}), strict=True)
    x = np.random.default_rng(4).normal(size=(5, 64)).astype(np.float32)
    for momentum in (False, True):
        jo, jfe = jmodel.apply({"params": params}, x, momentum=momentum,
                               return_feature=True)
        to, tfe = tmodel(torch.from_numpy(x), momentum=momentum,
                         return_feature=True)
        np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tfe.detach().numpy(), np.asarray(jfe),
                                   rtol=1e-5, atol=1e-6)
    jnew = _np_tree(jdisc.momentum_update(params))
    tdisc.momentum_update(tmodel)
    for k, v in from_flax({"params": jnew}).items():
        np.testing.assert_allclose(tmodel.state_dict()[k].numpy(), v.numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    tdisc.synchronize_parameters(tmodel)
    synced = _np_tree(jdisc.synchronize_parameters(jnew))
    for k, v in from_flax({"params": synced}).items():
        np.testing.assert_array_equal(tmodel.state_dict()[k].numpy(),
                                      v.numpy())


@pytest.fixture(scope="module")
def controller_pair():
    jspec = jctrl.ControllerSpec(num_ops=10)
    params = _np_tree(jctrl.init_params(jax.random.PRNGKey(2), jspec))
    params["outop"]["b"] = np.random.default_rng(5).normal(
        0, 0.1, 10).astype(np.float32)
    tspec = tctrl.ControllerSpec(num_ops=10)
    tmodel = tctrl.Controller(tspec)
    tmodel.load_state_dict(controller_from_jax(params), strict=True)
    return jspec, params, tmodel


def test_controller_sample_forced_and_evaluate(controller_pair):
    jspec, params, tmodel = controller_pair
    M = 6
    j_pol, _, _, _, _ = jctrl.sample(params, jspec, jax.random.PRNGKey(3), M)
    forced = np.asarray(j_pol)
    j_out = jctrl.sample(params, jspec, jax.random.PRNGKey(4), M,
                         forced_actions=jnp.asarray(forced))
    t_out = tmodel.sample(M, forced_actions=torch.from_numpy(
        forced.astype(np.int64)))
    np.testing.assert_array_equal(t_out[0].numpy(), np.asarray(j_out[0]))
    for t, j in zip(t_out[1:], j_out[1:]):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   rtol=1e-5, atol=1e-6)
    t_lp = tmodel.evaluate(torch.from_numpy(forced.astype(np.int64)))
    j_lp = jctrl.evaluate(params, jspec, jnp.asarray(forced))
    np.testing.assert_allclose(t_lp.detach().numpy(), np.asarray(j_lp),
                               rtol=1e-5, atol=1e-6)
    assert tctrl.policies_to_tensor(t_out[0], tmodel.spec).shape == (
        M, 5, 2, 2)


def test_controller_sample_draws_valid_tokens(controller_pair):
    _, _, tmodel = controller_pair
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        pol, op_p, mag_p, lp, ent = tmodel.sample(64, gen)
    toks = pol.reshape(64, 5, 2, 2)
    assert int(toks[..., 0].max()) < 10 and int(toks[..., 1].max()) < 10
    np.testing.assert_allclose(op_p.sum().item(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(lp.numpy(), tmodel.evaluate(pol).detach()
                               .numpy(), rtol=1e-5, atol=1e-5)
    assert bool(torch.all(ent > 0))
