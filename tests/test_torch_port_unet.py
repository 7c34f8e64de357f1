"""The port's UNet and model factory against the JAX package.

UNet (flax ``aadg_tpu.models.unet.UNet``, 6 blocks down, 5 up) at
2 x 64 x 64 in f32, loaded through ``weights.from_flax`` with perturbed
BatchNorm parameters and statistics, in train and eval mode: logits,
pooled bottleneck feature and updated BN statistics within rtol/atol
2e-4 (two f32 stacks of 23 convolutions summing in different orders; the
first up-sampling joins 512 + 512 channels).

Factory: ``class_parser``/``domain_parser``/``channel_parser`` equal the
JAX tables; ``build_entities`` takes the class count and the
discriminator's width from the model (rvs: one class, DeepLabV3+ 1280,
UNet 512), and unported models (the custom DeepLab and the DeepLabV3+
backbones other than MobileNetV2, ROADMAP queue 1, item 7c) raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aadg_tpu import models as jmodels
from aadg_tpu.config import load_config as jax_load_config
from aadg_tpu.engine import state as jstate
from aadg_tpu.models.unet import UNet as JUNet
from aadg_tpu_torch import models as tmodels
from aadg_tpu_torch.config import load_config
from aadg_tpu_torch.engine import state as tstate
from aadg_tpu_torch.models.unet import UNet
from aadg_tpu_torch.weights import from_flax
from torch_port_helpers import few_torch_threads  # noqa: F401

TOL = dict(rtol=2e-4, atol=2e-4)
RVS_FIXTURE = "tests/fixtures/synthetic_rvs.yaml"


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


@pytest.fixture(scope="module")
def unet_pair():
    jmodel = JUNet(in_channels=3, out_channels=1)
    variables = jax.jit(lambda k: jmodel.init(
        k, jnp.zeros((1, 64, 64, 3)), train=False))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def perturb(path, a):
        name = path[-1].key
        if name in ("scale", "var"):
            return rng.uniform(0.8, 1.2, a.shape).astype(np.float32)
        if name == "mean" or (name == "bias" and "BatchNorm" in str(path)):
            return rng.normal(0, 0.05, a.shape).astype(np.float32)
        return a

    params = jax.tree_util.tree_map_with_path(
        perturb, _np_tree(variables["params"]))
    stats = jax.tree_util.tree_map_with_path(
        perturb, _np_tree(variables["batch_stats"]))
    tmodel = UNet(3, 1)
    tmodel.load_state_dict(from_flax({"params": params, "batch_stats": stats}),
                           strict=True)
    return jmodel, params, stats, tmodel


def test_unet_structure(unet_pair):
    jmodel, params, _, tmodel = unet_pair
    assert sorted(params) == sorted(n for n, _ in tmodel.named_children())
    assert tmodel.feature_dim == jmodel.feature_dim == 512
    n_params = sum(p.numel() for p in tmodel.parameters())
    assert n_params == sum(a.size for a in jax.tree_util.tree_leaves(params))


def test_unet_train_mode_parity(unet_pair):
    jmodel, params, stats, tmodel = unet_pair
    x = np.random.default_rng(1).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    (jl, jf), upd = jax.jit(lambda p, s, x: jmodel.apply(
        {"params": p, "batch_stats": s}, x, train=True,
        mutable=["batch_stats"]))(params, stats, x)
    tmodel.train()
    tl, tf = tmodel(torch.from_numpy(x))
    assert tl.shape == (2, 64, 64, 1) and tf.shape == (2, 512)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tf.detach().numpy(), np.asarray(jf), **TOL)
    sd = tmodel.state_dict()
    for k, v in from_flax({"batch_stats": _np_tree(upd["batch_stats"])}
                          ).items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), **TOL,
                                   err_msg=k)
    tmodel.load_state_dict(from_flax({"params": params,
                                      "batch_stats": stats}))  # for eval


def test_unet_eval_mode_parity(unet_pair):
    jmodel, params, stats, tmodel = unet_pair
    x = np.random.default_rng(2).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    jl, jf = jax.jit(lambda p, s, x: jmodel.apply(
        {"params": p, "batch_stats": s}, x, train=False))(params, stats, x)
    tmodel.eval()
    with torch.no_grad():
        tl, tf = tmodel(torch.from_numpy(x))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **TOL)


@pytest.mark.parametrize("dataset", ["optic", "rvs"])
def test_parsers_equal_jax(dataset):
    assert tmodels.class_parser(dataset) == jmodels.class_parser(dataset)
    assert tmodels.domain_parser(dataset) == jmodels.domain_parser(dataset)


@pytest.mark.parametrize("backbone", ["mobilenet_v2", "unet"])
def test_channel_parser_equals_jax_and_models(backbone):
    assert tmodels.channel_parser(backbone) == jmodels.channel_parser(
        backbone)
    cls = UNet if backbone == "unet" else tmodels.DeepLabV3Plus
    assert cls.feature_dim == tmodels.channel_parser(backbone)


@pytest.mark.parametrize("cfg, opts, model, classes, feat", [
    ("experiments/rvs_sinkhorn/diversity_ex.yaml",
     ["DATASET.NAME", "synthetic_rvs"], "DeepLabV3Plus", 1, 1280),
    (RVS_FIXTURE, [], "UNet", 1, 512),
    ("experiments/optic_sinkhorn/diversity.yaml",
     ["DATASET.NAME", "synthetic_optic"], "DeepLabV3Plus", 2, 1280),
    ("tests/fixtures/synthetic_optic.yaml", ["MODEL.NAME", "unet"], "UNet",
     2, 512),
], ids=["rvs-deeplab", "rvs-unet", "optic-deeplab", "optic-unet"])
def test_entities_take_model_from_factory(cfg, opts, model, classes, feat):
    jent = jstate.build_entities(jax_load_config(cfg, opts), "search")
    ent = tstate.build_entities(load_config(cfg, opts), "search",
                                device="cpu")
    assert (ent.num_classes, ent.feature_dim) == (classes, feat)
    assert (jent.num_classes, jent.feature_dim) == (classes, feat)
    assert ent.n_domains == jent.n_domains == 3
    sd, _ = tstate.init_state(ent, 0)
    assert type(sd.model).__name__ == model
    assert sd.disc.online.dis.in_features == feat
    with torch.no_grad():
        logits, f = sd.model.eval()(torch.zeros(1, 32, 32, 3))
    assert logits.shape == (1, 32, 32, classes) and f.shape == (1, feat)


@pytest.mark.parametrize("opts", [["MODEL.NAME", "customdeeplab",
                                   "MODEL.BACKBONE", "xception"],
                                  ["MODEL.BACKBONE", "resnet50"]])
def test_unported_models_raise(opts):
    cfg = load_config(RVS_FIXTURE if opts[1] == "customdeeplab"
                      else "experiments/rvs_sinkhorn/diversity_ex.yaml",
                      opts)
    with pytest.raises(NotImplementedError, match="queue 1, item 7"):
        tstate.build_entities(cfg, "search", device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1, item 7"):
        tmodels.build_model(cfg, 1)
