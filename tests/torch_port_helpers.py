"""Shared helpers of the port's parity tests (tests/test_torch_port_*.py).

JAX's threefry bits cannot be reproduced by torch's generators, so every
randomized function of the port takes its draws as tensors. The ``*_draws``
helpers walk the JAX key trees exactly as ``aadg_tpu`` does and return the
numbers JAX drew, as numpy arrays, for the port's apply functions. The rest
builds one JAX/port pair of search-step states from the same weights and
compares what the two steps produce.
"""

from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aadg_tpu.config import load_config as jax_load_config
from aadg_tpu.engine import state as jstate
from aadg_tpu_torch.config import load_config
from aadg_tpu_torch.data.datasets import SyntheticDataset
from aadg_tpu_torch.data.transforms import ScaleCropDraw
from aadg_tpu_torch.engine import state as tstate
from aadg_tpu_torch.weights import from_flax, leaf_name


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads per test module, restored afterwards: the suite
    runs several pytest workers at once, and each torch process taking
    every core for its small CPU kernels slowed these tests fivefold."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def policy_draws(keys, M, Q, L, h, w):
    """Per-sample keys (N, 2) of ``make_multi_policy_applier`` ->
    q (N, M) int64 and Cutout centres (N, M, L, 2) f32 (x, y)."""
    def one(key_nm):
        kq, kops = jax.random.split(key_nm)
        q = jax.random.randint(kq, (), 0, Q)
        ks = jax.random.split(kops, L)

        def centre(k):
            kx, ky = jax.random.split(k)
            return jnp.stack([
                jax.random.uniform(kx, (), minval=0.0, maxval=float(w)),
                jax.random.uniform(ky, (), minval=0.0, maxval=float(h))])
        return q, jax.vmap(centre)(ks)

    def per_sample(key):
        return jax.vmap(one)(jax.random.split(key, M))

    q, c = jax.vmap(per_sample)(keys)
    return np.array(q, np.int64), np.array(c, np.float32)


def scale_crop_draws(keys, scale_range, p_noscale=0.2):
    """Per-sample keys (N, 2) of ``random_scale_crop`` -> (sw, sh, ux, uy)."""
    lo, hi = scale_range

    def one(key):
        k1, k2, k3, k4, k5 = jax.random.split(key, 5)
        do_scale = jax.random.uniform(k1) > p_noscale
        sw = jnp.where(do_scale, jax.random.uniform(k2, minval=lo,
                                                    maxval=hi), 1.0)
        sh = jnp.where(do_scale, jax.random.uniform(k3, minval=lo,
                                                    maxval=hi), 1.0)
        return sw, sh, jax.random.uniform(k4), jax.random.uniform(k5)

    return tuple(np.array(a, np.float32) for a in jax.vmap(one)(keys))


def soft_label_draws(keys, n):
    """Per-sample keys (N, 2) of ``soft_domain_label`` -> (N, n) uniforms
    in the port's layout (key 0, then keys 1..n-1)."""
    def one(key):
        ks = jax.random.split(key, n + 1)
        return jnp.stack([jax.random.uniform(ks[i]) for i in range(n)])

    return np.array(jax.vmap(one)(keys), np.float32)


CROP, M = 64, 2
OPTS = ["DATASET.NAME", "synthetic_optic", "TPU.CROP_SIZE", "64",
        "TRAIN.BATCH_SIZE", "1", "CONTROLLER.M", "2",
        "TPU.COMPUTE_DTYPE", "float32", "TRAIN.WD", "0.0001"]
CFG = "experiments/optic_sinkhorn/diversity.yaml"
# the flagship rvs config (DeepLabV3+, one class) cut to crop 32 from 64^2
# vessel pools, so the scale-crop draws scales in [0.5, 2]
RVS_CROP = 32
RVS_OPTS = ["DATASET.NAME", "synthetic_rvs", "TPU.CROP_SIZE", "32",
            "TRAIN.BATCH_SIZE", "1", "CONTROLLER.M", "2",
            "TPU.COMPUTE_DTYPE", "float32", "TRAIN.WD", "0.0001"]
RVS_CFG = "experiments/rvs_sinkhorn/diversity_ex.yaml"
# the SegFormer config cut to MiT-b0 at crop 64 with stochastic depth 0.5,
# so the 6 crops of a search step drop branches; the JAX model runs
# without remat (its masks are probed from the unlifted blocks) and the
# port's with it
SEG_CFG = "experiments/zoo/segformer_b4_optic.yaml"
SEG_OPTS = OPTS + ["MODEL.BACKBONE", "mit_b0", "MODEL.DROP_PATH_RATE", "0.5"]


def _capture():
    """An optax transform whose state after update is the gradient and whose
    update is zero: the JAX step then hands back its gradients."""
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)
    return optax.GradientTransformation(
        zeros, lambda g, s, p=None: (zeros(g), g))


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def step_pair(task: str = "optic"):
    """(JAX entities with gradient-capturing optimizers, JAX state, port
    entities, raw batch (1, 3, 64, 64, 3)) at the flagship config of
    ``task`` cut to B=1, M=2, f32: optic at crop 64, rvs at crop 32;
    ``segformer`` is the optic task on ``SEG_CFG``/``SEG_OPTS``."""
    cfg, opts, crop = {"optic": (CFG, OPTS, CROP),
                       "rvs": (RVS_CFG, RVS_OPTS, RVS_CROP),
                       "segformer": (SEG_CFG, SEG_OPTS, CROP)}[task]
    port_opts = opts
    if task == "segformer":
        opts, port_opts = (opts + ["TPU.REMAT", "False"],
                           opts + ["TPU.REMAT", "True"])
    jcfg = jax_load_config(cfg, opts)
    jent = jstate.build_entities(jcfg, "search", steps_per_epoch=1)
    jent = jent._replace(model_tx=_capture(), dis_tx=_capture())
    k_model, k_dis = jax.random.split(jax.random.PRNGKey(0))
    variables = jax.jit(lambda k: jent.model.init(
        k, jnp.zeros((1, crop, crop, 3)), train=False))(k_model)
    dis_params = jent.disc.init(k_dis, jnp.zeros((1, jent.feature_dim)))[
        "params"]
    sd = jstate.SegDisState(
        seg_params=variables["params"], seg_stats=variables["batch_stats"],
        seg_opt=jent.model_tx.init(variables["params"]),
        dis_params=dis_params, dis_stats={},
        dis_opt=jent.dis_tx.init(dis_params))
    tent = tstate.build_entities(load_config(cfg, port_opts), "search",
                                 steps_per_epoch=1, device="cpu")
    ds = SyntheticDataset("rvs" if task == "rvs" else "optic",
                          n_per_domain=1, size=64)
    imgs = np.stack([d.images[0] for d in ds.domains])[None].astype(
        np.float32)                                   # (1, 3, 64, 64, 3)
    masks = np.stack([d.labels[0] for d in ds.domains])[None].astype(
        np.float32)
    dcs = np.arange(3, dtype=np.int32)[None]
    return jent, sd, tent, (imgs, masks, dcs)


def dropout_draws(model, variables, shape, key):
    """The masks a train-mode ``apply`` of the flax SegFormer ``model``
    (unlifted blocks) on inputs of ``shape`` draws from the dropout key
    ``key``, as the port's ``SegFormerDropout`` of bool numpy arrays.
    Every ``DropPath`` and ``Dropout`` call is run on ones instead of its
    input, so its output is nonzero exactly where its mask keeps; the
    masks depend on the key and the module path, not on the values."""
    from flax import linen as nn
    from aadg_tpu.models.segformer import VARIANTS, DropPath
    from aadg_tpu_torch.models.segformer import SegFormerDropout

    def probe(variables, key):
        seen = {}

        def record(next_fun, args, kwargs, context):
            m = context.module
            if (context.method_name != "__call__"
                    or not isinstance(m, (DropPath, nn.Dropout))):
                return next_fun(*args, **kwargs)
            out = next_fun(jnp.ones_like(args[0]), *args[1:], **kwargs)
            seen["/".join(m.scope.path)] = out != 0
            return out
        with nn.intercept_methods(record):
            model.apply(variables, jnp.zeros(shape), train=True,
                        mutable=["batch_stats"], rngs={"dropout": key})
        return seen

    seen = jax.jit(probe)(variables, key)
    depths = VARIANTS[model.variant][1]
    paths = np.stack([
        np.stack([np.asarray(seen[f"backbone/block{i + 1}_{j}/{dp}"])[:, 0, 0]
                  for dp in ("dp1", "dp2")])
        for i in range(4) for j in range(depths[i])])
    return SegFormerDropout(paths, np.asarray(seen["head/Dropout_0"]))


def torch_dropout(draws):
    return type(draws)(*(torch.from_numpy(np.array(a)) for a in draws))


def sharpen_seg_head(sd, gain=50.0, threshold=0.75):
    """``sd`` with the segmentation head's kernel scaled by ``gain`` and its
    bias at logit(threshold). At initialization the logits sit within
    +-0.05 of 0, so every mask at the 0.75 threshold would be empty; after
    this they spread over a few units around the threshold and the maps
    have both classes."""
    head = dict(sd.seg_params["seg_head"])
    head["kernel"] = head["kernel"] * gain
    head["bias"] = jnp.full_like(head["bias"],
                                 np.log(threshold / (1.0 - threshold)))
    return sd._replace(seg_params={**sd.seg_params, "seg_head": head})


def port_state(tent, sd):
    tsd, _ = tstate.init_state(tent, 0)
    tsd.model.load_state_dict(from_flax({"params": _np(sd.seg_params),
                                         "batch_stats": _np(sd.seg_stats)}),
                              strict=True)
    tsd.disc.load_state_dict(from_flax({"params": _np(sd.dis_params)}),
                             strict=True)
    return tsd


def torch_batch(batch):
    imgs, masks, dcs = batch
    return (torch.from_numpy(imgs), torch.from_numpy(masks),
            torch.from_numpy(dcs.astype(np.int64)))


def crop_draw(keys, scale_range=(1.0, 1.5)):
    return ScaleCropDraw(*(torch.from_numpy(a) for a in
                           scale_crop_draws(keys, scale_range)))


def check_grads(module, jgrads, tight: bool):
    """Compare ``.grad`` of every trainable parameter with the JAX
    gradients (see the module docstring for the two criteria)."""
    ref = from_flax({"params": _np(jgrads)})
    pairs = [(k, p.grad.numpy(), ref[k].numpy())
             for k, p in module.named_parameters() if p.requires_grad]
    assert len(pairs) == sum(p.requires_grad for p in module.parameters())
    if tight:
        for k, g, j in pairs:
            scale = max(float(np.abs(j).max()), 1e-12)
            np.testing.assert_allclose(g, j, rtol=0, atol=1e-3 * scale,
                                       err_msg=k)
        return
    g_all = np.concatenate([g.ravel() for _, g, _ in pairs])
    j_all = np.concatenate([j.ravel() for _, _, j in pairs])
    assert np.linalg.norm(g_all - j_all) <= 0.15 * np.linalg.norm(j_all)
    top = max(np.linalg.norm(j) for _, _, j in pairs)
    for k, g, j in pairs:
        if np.linalg.norm(j) > 0.01 * top:
            assert np.linalg.norm(g - j) <= 0.25 * np.linalg.norm(j), k


def check_grads_floored(module, jgrads, floor: float = 1e-7):
    """Every trainable parameter's ``.grad`` within 1e-3 of the JAX
    gradient's largest magnitude in that tensor, or within ``floor`` of the
    module's largest gradient for a tensor whose gradient vanishes
    (SegFormer's ``linear_c*`` biases: a per-channel shift before a
    train-mode BatchNorm has gradient 0 up to f32 rounding)."""
    ref = from_flax({"params": _np(jgrads)})
    top = max(float(np.abs(v.numpy()).max()) for v in ref.values())
    names = [k for k, p in module.named_parameters() if p.requires_grad]
    assert sorted(names) == sorted(ref)
    for k, p in module.named_parameters():
        j = ref[k].numpy()
        atol = max(1e-3 * float(np.abs(j).max()), floor * top)
        np.testing.assert_allclose(p.grad.numpy(), j, rtol=0, atol=atol,
                                   err_msg=k)


def check_stats(model, jstats):
    sd = model.state_dict()
    for k, v in from_flax({"batch_stats": _np(jstats)}).items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=2e-4,
                                   atol=2e-4, err_msg=k)


def check_metrics(tm, jm):
    assert set(tm) == set(jm)
    for k in ("seg_loss", "dis_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4)
    for k in (k for k in tm if k.endswith("dsc")):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-3)


def to_flax(state_dict, template):
    """The inverse of ``weights.from_flax``: numpy arrays in the layout of
    the flax tree ``template`` ({"params": ..., "batch_stats": ...}) from a
    port state_dict."""
    def walk(tree, prefix):
        out = {}
        for name, value in tree.items():
            if isinstance(value, Mapping):
                out[name] = walk(value, f"{prefix}{name}.")
                continue
            key = prefix + leaf_name(name, tree)
            arr = state_dict[key].detach().cpu().numpy()
            if name == "kernel":
                arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
            assert arr.shape == np.shape(value), (prefix, name)
            out[name] = np.ascontiguousarray(arr, np.float32)
        return out
    return {k: walk(v, "") for k, v in template.items()}
