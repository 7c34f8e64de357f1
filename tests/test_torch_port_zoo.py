"""The port's zoo (``aadg_tpu_torch/models/zoo``) against the JAX package's
(``aadg_tpu/models/zoo``), f32 on the CPU, module by module.

Weights are drawn with numpy from a seed over the flax tree's shapes
(``jax.eval_shape`` of ``init``: He-scaled kernels, BatchNorm scales and
variances in [0.5, 1.5], biases and means ~ N(0, 0.1)) and carried to the
port by ``weights.from_flax``; inputs are numpy draws from a seed; the JAX
modules run jitted (an un-jitted HRNet compiles each of its ~1000
operations alone, slower than the one program).

- ``resize``, ``bilinear_resize`` (``align_corners`` both ways),
  ``adaptive_avg_pool`` and ``transform_inputs`` (``resize_concat``)
  within 1e-6;
- (the backbones: ``test_torch_port_zoo_backbones.py``);
- each head (FCN plain, on HRNet's ``resize_concat`` and on UNet's
  full-resolution output; PSP; LRASPP with the global gate and with the
  sliding 49 x 49 gate; OCR) on feature lists of the backbones' widths,
  train (the port applying the dropout masks the JAX module drew) and
  eval, within rtol 1e-4 and atol 1e-4 of the output's largest magnitude,
  and the updated running statistics likewise;
- for the five configured segmentors, every architecture over
  ResNetV1c-50 and the FCN over every other ported backbone,
  ``from_flax`` maps every parameter and BatchNorm statistic (and
  EMAHead's bases) of the flax tree onto the port's state_dict and
  ``to_flax`` maps it back, with no leaf left over on either side;
- the builder: pooled-feature widths equal JAX's segmentors' (the
  backbone's ``channel_parser``, or the FPN's for ``sem_fpn`` and
  ``pointrend``), the draws hold one mask per dropout, and pairs over the
  last backbones ported (ResNeSt, FastSCNN, CGNet) build through the
  factory and the entities.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from aadg_tpu import models as jmodels
from aadg_tpu.config import load_config as jax_load_config
from aadg_tpu.engine import state as jstate
from aadg_tpu.models.zoo import attention_heads as jah
from aadg_tpu.models.zoo import backbones as jbb
from aadg_tpu.models.zoo import builder as jbuilder
from aadg_tpu.models.zoo import heads as jheads
from aadg_tpu.models.zoo import layers as jlayers
from aadg_tpu_torch import models as tmodels
from aadg_tpu_torch.config import load_config
from aadg_tpu_torch.engine import state as tstate
from aadg_tpu_torch.models.zoo import attention_heads as tah
from aadg_tpu_torch.models.zoo import backbones as tbb
from aadg_tpu_torch.models.zoo import builder as tbuilder
from aadg_tpu_torch.models.zoo import heads as theads
from aadg_tpu_torch.models.zoo import layers as tlayers
from aadg_tpu_torch.weights import from_flax
from torch_port_helpers import few_torch_threads  # noqa: F401
from torch_port_helpers import _np, to_flax


def numpy_variables(module, *args, seed=0, **kwargs):
    """Seeded numpy weights over the shapes of ``module.init(*args)``."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    rng = np.random.default_rng(seed)

    def fill(path, sds):
        name, shape = path[-1].key, sds.shape
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        std = (math.sqrt(2.0 / np.prod(shape[:-1])) if name == "kernel"
               else 0.1)
        return rng.standard_normal(shape, np.float32) * np.float32(std)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def close(got, want, tol=1e-4):
    """Within rtol 1e-4 and atol ``tol`` of the reference's largest value."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=tol * max(np.abs(want).max(), 1e-6))


def japply(module, variables, *args, train, key=None):
    """Jitted ``module.apply``: (output, updated batch_stats) in train
    mode, the output in eval mode."""
    def run(variables, args):
        if not train:
            return module.apply(variables, *args, train=False)
        out, upd = module.apply(variables, *args, train=True,
                                mutable=["batch_stats"],
                                rngs=None if key is None
                                else {"dropout": key})
        return out, upd["batch_stats"]
    return jax.jit(run)(variables, args)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def port(module, variables):
    module.load_state_dict(from_flax(variables), strict=True)
    return module


def check_stats(module, jstats):
    sd = module.state_dict()
    for k, v in from_flax({"batch_stats": _np(jstats)}).items():
        close(sd[k], v.numpy())


def jax_dropout_masks(module, variables, args, key):
    """The keep masks of every ``nn.Dropout`` call of a train-mode apply of
    ``module`` on ``args`` with dropout key ``key``, in call order: each
    Dropout runs on ones, so its output is nonzero where it keeps. The
    masks depend on the key and the module path, not on the inputs."""
    def probe(variables, args):
        masks = []

        def record(next_fun, a, kw, context):
            if (context.method_name == "__call__"
                    and isinstance(context.module, fnn.Dropout)):
                out = next_fun(jnp.ones_like(a[0]), *a[1:], **kw)
                masks.append(out != 0)
                return out
            return next_fun(*a, **kw)
        with fnn.intercept_methods(record):
            module.apply(variables, *args, train=True,
                         mutable=["batch_stats"], rngs={"dropout": key})
        return masks
    return [torch.from_numpy(np.array(m))
            for m in jax.jit(probe)(variables, args)]


# -- layers -----------------------------------------------------------------

@pytest.mark.parametrize("src,dst", [((7, 9), (16, 20)), ((16, 20), (7, 9)),
                                     ((8, 12), (5, 30)), ((1, 1), (6, 4))])
def test_resize_matches_jax(src, dst):
    x = np.random.default_rng(0).normal(size=(2, *src, 3)).astype(np.float32)
    want = jlayers.resize(jnp.asarray(x), dst)
    got = nhwc(tlayers.resize(nchw(x), dst))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("align_corners", [False, True])
def test_bilinear_resize_matches_jax(align_corners):
    x = np.random.default_rng(1).normal(size=(2, 9, 6, 3)).astype(np.float32)
    for dst in ((17, 4), (5, 11)):
        want = jlayers.bilinear_resize(jnp.asarray(x), dst, align_corners)
        got = nhwc(tlayers.bilinear_resize(nchw(x), dst, align_corners))
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("out", [1, 2, 3, 6, (4, 5)])
def test_adaptive_avg_pool_matches_jax(out):
    x = np.random.default_rng(2).normal(size=(2, 7, 10, 4)).astype(
        np.float32)
    want = jlayers.adaptive_avg_pool(jnp.asarray(x), out)
    got = nhwc(tlayers.adaptive_avg_pool(nchw(x), out))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)


def test_transform_inputs_matches_jax():
    rng = np.random.default_rng(3)
    xs = [rng.normal(size=(2, s, s + 2, c)).astype(np.float32)
          for s, c in ((16, 3), (8, 4), (4, 5), (2, 6))]
    want = jlayers.transform_inputs([jnp.asarray(x) for x in xs],
                                    (0, 1, 2, 3), "resize_concat")
    got = tlayers.transform_inputs([nchw(x) for x in xs], (0, 1, 2, 3),
                                   "resize_concat")
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert tlayers.input_channels([3, 4, 5, 6], (0, 1, 2, 3),
                                  "resize_concat") == want.shape[-1]
    assert tlayers.transform_inputs([nchw(x) for x in xs], -1, None) \
        .shape[1] == 6


# -- heads ------------------------------------------------------------------

R50 = ([256, 512, 1024, 2048], [8, 8, 8, 8])
HR18 = ([18, 36, 72, 144], [16, 8, 4, 2])
HR_WIRE = dict(in_index=(0, 1, 2, 3), input_transform="resize_concat")
HEADS = {
    # name: (JAX head, port head, (widths, sides) of the feature list)
    "fcn": (lambda: jheads.FCNHead(2, channels=512),
            lambda c: theads.FCNHead(c, 2, channels=512), R50),
    "fcn_hrnet": (lambda: jheads.FCNHead(1, channels=512, num_convs=1,
                                         concat_input=False, **HR_WIRE),
                  lambda c: theads.FCNHead(c, 1, channels=512, num_convs=1,
                                           concat_input=False, **HR_WIRE),
                  HR18),
    "fcn_unet": (lambda: jheads.FCNHead(1, channels=512, in_index=4),
                 lambda c: theads.FCNHead(c, 1, channels=512, in_index=4),
                 ([1024, 512, 256, 128, 64], [2, 4, 8, 16, 32])),
    "psp": (lambda: jheads.PSPHead(2, channels=512),
            lambda c: theads.PSPHead(c, 2, channels=512),
            ([256, 512, 1024, 2048], [9, 9, 9, 9])),
    "lraspp_global": (lambda: jheads.LRASPPHead(2, channels=128),
                      lambda c: theads.LRASPPHead(c, 2, channels=128),
                      ([24, 40, 160], [32, 16, 4])),
    "lraspp_sliding": (lambda: jheads.LRASPPHead(2, channels=128),
                       lambda c: theads.LRASPPHead(c, 2, channels=128),
                       ([24, 40, 160], [280, 140, 70])),
    "ocr": (lambda: jah.OCRHead(2, channels=512, ocr_channels=256,
                                **HR_WIRE),
            lambda c: tah.OCRHead(c, 2, channels=512, ocr_channels=256,
                                  **HR_WIRE), HR18),
}


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", sorted(HEADS))
def test_head_matches_jax(name, train):
    jfn, tfn, (widths, sides) = HEADS[name]
    rng = np.random.default_rng(6)
    feats = [rng.normal(size=(2, s, s + 1, c)).astype(np.float32)
             for c, s in zip(widths, sides)]
    jin = [jnp.asarray(f) for f in feats]
    args = (jin,)
    targs = ([nchw(f) for f in feats],)
    if name == "ocr":
        prev = rng.normal(size=(2, 8, 9, 2)).astype(np.float32)
        args, targs = (jin, jnp.asarray(prev)), (targs[0], nchw(prev))
    jmod = jfn()
    variables = numpy_variables(jmod, *args, train=False)
    tmod = port(tfn(widths), variables).train(train)
    key = jax.random.PRNGKey(8)
    if train:
        masks = jax_dropout_masks(jmod, variables, args, key)
        assert len(masks) == 1 and not masks[0].all()
        want, upd = japply(jmod, variables, *args, train=True, key=key)
        got = tmod(*targs, masks[0])
    else:
        want = japply(jmod, variables, *args, train=False)
        got = tmod(*targs)
    close(nhwc(got), want)
    if train:
        check_stats(tmod, upd)


def test_lraspp_gate_branches():
    """A top stage of at least 49 x 49 gets the sliding gate (49 x 49
    windows, strides (16, 20)), a smaller one the global pool."""
    head = theads.LRASPPHead([1, 1, 1], 2, channels=4).eval()
    seen = []
    head.image_pool.register_forward_pre_hook(
        lambda m, a: seen.append(tuple(a[0].shape)))
    with torch.no_grad():
        for side in (70, 48):
            head([torch.zeros(1, 1, 4 * side, 4 * side + 4),
                  torch.zeros(1, 1, 2 * side, 2 * side + 2),
                  torch.zeros(1, 1, side, side + 1)])
    assert seen == [(1, 1, 2, 2), (1, 1, 1, 1)]


def test_train_forward_needs_masks():
    head = theads.FCNHead([8], 2, channels=4).train()
    with pytest.raises(ValueError, match="dropout mask"):
        head([torch.zeros(2, 8, 4, 4)])


# -- segmentors: weight maps and the builder ---------------------------------

# the configured segmentors, every architecture over ResNetV1c-50, and the
# FCN over every other ported backbone
CONFIGS = ([("pspnet", "resnet50_v1c", 2),
            ("lraspp", "mobilenet_v3_large", 2),
            ("lraspp", "mobilenet_v3_small", 2), ("ocrnet", "hrnet_w18", 1),
            ("fcn", "unet_s5_d16", 1)]
           + [(a, "resnet50_v1c", 2) for a in tbuilder.ZOO_ARCHS
              if a != "pspnet"]
           + [("fcn", b, 1) for b in ("resnet101_v1c", "resnext50",
                                      "resnext101", "hrnet_w32",
                                      "hrnet_w48")])


@pytest.mark.parametrize("arch,backbone,classes", CONFIGS)
def test_weight_maps_cover_every_zoo_leaf(arch, backbone, classes):
    jmodel, jch = jbuilder.build_segmentor(arch, backbone, classes)
    variables = numpy_variables(jmodel, np.zeros((1, 64, 64, 3), np.float32),
                                train=False)
    with torch.device("meta"):   # shapes only: the weights come from sd
        tmodel, tch = tbuilder.build_segmentor(arch, backbone, classes)
    assert tch == jch == tbuilder.feature_dim(arch, backbone)
    if arch not in ("sem_fpn", "pointrend"):
        assert tch == tmodels.channel_parser(backbone) \
            == jmodels.channel_parser(backbone)
    sd = from_flax(variables)
    own = tmodel.state_dict()
    assert sorted(sd) == sorted(own)
    for k, v in sd.items():
        assert v.shape == own[k].shape, k
    tmodel.load_state_dict(sd, strict=True, assign=True)
    back = to_flax(tmodel.state_dict(), variables)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back,
                           _np(variables))


@pytest.mark.parametrize("opts", [
    ["MODEL.NAME", "upernet", "MODEL.BACKBONE", "resnest101"],
    ["MODEL.NAME", "deeplabv3", "MODEL.BACKBONE", "cgnet"],
    ["MODEL.NAME", "fcn", "MODEL.BACKBONE", "resnest50"],
    ["MODEL.NAME", "pspnet", "MODEL.BACKBONE", "fast_scnn"]])
def test_last_zoo_backbones_build(opts):
    """The names that raised until ResNeSt, Fast-SCNN and CGNet were
    ported build through the factory and the entities, with JAX's pooled
    width, and give logits of the input's size (shapes only, on the meta
    device)."""
    cfg = load_config("experiments/zoo/pspnet_r50_optic.yaml",
                      ["DATASET.NAME", "synthetic_optic", "TPU.CROP_SIZE",
                       "64", *opts])
    jcfg = jax_load_config("experiments/zoo/pspnet_r50_optic.yaml",
                           ["DATASET.NAME", "synthetic_optic", *opts])
    ent = tstate.build_entities(cfg, "search", device="cpu")
    assert ent.feature_dim == jbuilder.build_segmentor(
        opts[1], opts[3], 2)[1] == tmodels.channel_parser(opts[3]) \
        == jmodels.channel_parser(opts[3])
    assert type(jmodels.build_model(jcfg)).__name__ == "EncoderDecoder"
    with torch.device("meta"):
        model = tmodels.build_model(cfg, 2)
    with torch.no_grad():
        logits, feat = model.eval()(torch.zeros(1, 64, 64, 3,
                                                device="meta"))
    assert tuple(logits.shape) == (1, 64, 64, 2)
    assert tuple(feat.shape) == (1, ent.feature_dim)


@pytest.mark.parametrize("arch", ["sem_fpn", "pointrend", "annnet",
                                  "fast_scnn"])
def test_entities_take_the_segmentors_feature_and_dropouts(arch):
    """The discriminator reads the segmentor's pooled width (the FPN's 256
    for sem_fpn and pointrend, as JAX's ``model.feature_dim``), and the
    draws hold one mask per dropout of the heads' train forward (ANN's
    two)."""
    opts = ["DATASET.NAME", "synthetic_optic", "TPU.CROP_SIZE", "32",
            "MODEL.NAME", arch]
    jent = jstate.build_entities(
        jax_load_config("experiments/zoo/pspnet_r50_optic.yaml", opts),
        "search")
    ent = tstate.build_entities(
        load_config("experiments/zoo/pspnet_r50_optic.yaml", opts),
        "search", device="cpu")
    assert ent.feature_dim == jent.feature_dim
    masks = ent.draw_dropout(2, torch.Generator().manual_seed(0))
    shapes = [tuple(m.shape) for m in masks]
    assert shapes == {"annnet": [(2, 4, 4, 2048), (2, 4, 4, 512)],
                      "fast_scnn": [(2, 4, 4, 128)]}.get(
        arch, [(2, 8, 8, 128)])


@pytest.mark.parametrize("cfg,data,feat", [
    ("pspnet_r50_optic", "synthetic_optic", 2048),
    ("lraspp_mnv3_optic", "synthetic_optic", 160),
    ("ocrnet_hr18_rvs", "synthetic_rvs", 144),
    ("fcn_unet_rvs", "synthetic_rvs", 64)])
def test_entities_take_the_zoo_model(cfg, data, feat):
    c = load_config(f"experiments/zoo/{cfg}.yaml",
                    ["DATASET.NAME", data, "TPU.CROP_SIZE", "32"])
    ent = tstate.build_entities(c, "search", device="cpu")
    assert ent.feature_dim == feat
    masks = ent.draw_dropout(3, torch.Generator().manual_seed(0))
    heads = 2 if cfg.startswith("ocrnet") else 1
    assert len(masks) == heads
    assert all(m.dtype == torch.bool and m.shape[0] == 3 for m in masks)
    kept = torch.cat([m.flatten() for m in masks]).float().mean()
    assert 0.85 < float(kept) < 0.95
