"""The port's zoo heads of slice 7 against the JAX package's, f32 on the
CPU, at narrow widths (heads of 16 channels on feature lists of 8-24
channels and 2-16 pixels a side): the cases of every new head
(``aadg_tpu_torch/models/zoo/heads.py`` and ``attention_heads.py``; this
file runs the conv/pyramid family, ``test_torch_port_zoo_attention.py``
the attention family), the FPN neck and PointRend's eval side.

Weights are seeded numpy draws over the flax tree's shapes
(``test_torch_port_zoo.numpy_variables``; EncHead's codeword scale drawn
negative, as its initializer does); inputs and output cotangents are
numpy draws. Every head runs

- in train mode, the port applying the dropout masks the JAX module drew
  from its key: the logits, the updated BatchNorm statistics (and
  EMAHead's bases), and the gradients of the sum of the logits times a
  fixed cotangent with respect to every parameter and every input
  feature; a parameter the JAX gradient leaves at exactly 0 (EMAHead's
  ``ema_mid_conv``, DAHead's ``pam_cls``/``cam_cls``, EncHead's
  ``se_layer``) gets no gradient in the port;
- in eval mode, in f32: the logits.

The train forward and its gradients run in float64 on both sides: flax's
BatchNorm takes the batch variance as E[x^2] - E[x]^2, which in f32 moved
gradients of these narrow heads by up to 8% from JAX's own float64 result
(APCHead's 3 x 3 pooled branch), where the port, in f32 or float64, is
within 5e-8 of it. Tolerances: train outputs, statistics and gradients
within rtol 1e-6 and atol 1e-6 of the reference's largest magnitude
(1e-9 of the head's largest gradient for tensors whose gradient is
rounding noise: a per-channel shift before a train-mode BatchNorm); eval
outputs, in f32, within rtol 1e-4 and atol 1e-4 of the largest.
``point_sample`` on its own, the FPN neck's outputs, and PointRend's
refine (FPN outputs and coarse logits with no ties among the
uncertainties) within 1e-6; ``nearest_resize`` at non-integer ratios
exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aadg_tpu.models.zoo import attention_heads as jah
from aadg_tpu.models.zoo import heads as jheads
from aadg_tpu.models.zoo import necks as jnecks
from aadg_tpu.models.zoo import point_head as jph
from aadg_tpu_torch.models.zoo import attention_heads as tah
from aadg_tpu_torch.models.zoo import heads as theads
from aadg_tpu_torch.models.zoo import necks as tnecks
from aadg_tpu_torch.models.zoo import point_head as tph
from aadg_tpu_torch.models.zoo.segmentor import n_dropout
from aadg_tpu_torch.weights import from_flax
from test_torch_port_zoo import (close, jax_dropout_masks, nchw, nhwc,
                                 numpy_variables, port)
from torch_port_helpers import few_torch_threads  # noqa: F401

CH = 16
# (channels, height, width) of each stage
OS8 = [(8, 12, 13), (12, 6, 7), (16, 6, 7), (24, 6, 7)]
PYR = [(8, 16, 17), (12, 8, 9), (16, 4, 5), (24, 2, 3)]
HR_WIRE = dict(in_index=(0, 1, 2, 3), input_transform="resize_concat")

HEADS = {
    # name: (JAX head, port head (stage widths), stages)
    "dsfcn": (lambda: jheads.DepthwiseSeparableFCNHead(2, channels=CH,
                                                        in_index=2),
              lambda c: theads.DepthwiseSeparableFCNHead(c, 2, channels=CH,
                                                         in_index=2), OS8),
    "dsfcn_cat_hrnet": (
        lambda: jheads.DepthwiseSeparableFCNHead(
            1, channels=CH, concat_input=True, **HR_WIRE),
        lambda c: theads.DepthwiseSeparableFCNHead(
            c, 1, channels=CH, concat_input=True, **HR_WIRE), PYR),
    "aspp": (lambda: jheads.ASPPHead(2, channels=CH),
             lambda c: theads.ASPPHead(c, 2, channels=CH), OS8),
    "sep_aspp": (lambda: jheads.DepthwiseSeparableASPPHead(2, channels=CH),
                 lambda c: theads.DepthwiseSeparableASPPHead(
                     c, 2, channels=CH), OS8),
    "sep_aspp_hrnet": (
        lambda: jheads.DepthwiseSeparableASPPHead(1, channels=CH,
                                                  dilations=(1, 2, 3),
                                                  **HR_WIRE),
        lambda c: theads.DepthwiseSeparableASPPHead(
            c, 1, channels=CH, dilations=(1, 2, 3), **HR_WIRE), PYR),
    "uper": (lambda: jheads.UPerHead(2, channels=CH),
             lambda c: theads.UPerHead(c, 2, channels=CH), PYR),
    "fpn_head": (lambda: jheads.FPNHead(2, channels=CH),
                 lambda c: theads.FPNHead(c, 2, channels=CH), PYR),
    "fpn_head_os8": (
        lambda: jheads.FPNHead(2, channels=CH, feature_strides=(4, 8, 8, 8)),
        lambda c: theads.FPNHead(c, 2, channels=CH,
                                 feature_strides=(4, 8, 8, 8)), OS8),
    "nl": (lambda: jah.NLHead(2, channels=CH),
           lambda c: tah.NLHead(c, 2, channels=CH), OS8),
    "gc": (lambda: jah.GCHead(2, channels=CH),
           lambda c: tah.GCHead(c, 2, channels=CH), OS8),
    "dnl": (lambda: jah.DNLHead(2, channels=CH),
            lambda c: tah.DNLHead(c, 2, channels=CH), OS8),
    "cc": (lambda: jah.CCHead(2, channels=CH),
           lambda c: tah.CCHead(c, 2, channels=CH), OS8),
    "ann": (lambda: jah.ANNHead(2, channels=CH, project_channels=8),
            lambda c: tah.ANNHead(c, 2, channels=CH, project_channels=8),
            OS8),
    "ann_pyramid": (lambda: jah.ANNHead(1, channels=CH, project_channels=8),
                    lambda c: tah.ANNHead(c, 1, channels=CH,
                                          project_channels=8), PYR),
    "apc": (lambda: jah.APCHead(2, channels=CH),
            lambda c: tah.APCHead(c, 2, channels=CH), OS8),
    "dm": (lambda: jah.DMHead(2, channels=CH),
           lambda c: tah.DMHead(c, 2, channels=CH), OS8),
    "dm_even_fusion": (
        lambda: jah.DMHead(2, channels=CH, filter_sizes=(2, 4), fusion=True),
        lambda c: tah.DMHead(c, 2, channels=CH, filter_sizes=(2, 4),
                             fusion=True), OS8),
    "ema": (lambda: jah.EMAHead(2, channels=CH, ema_channels=CH,
                                num_bases=8),
            lambda c: tah.EMAHead(c, 2, channels=CH, ema_channels=CH,
                                  num_bases=8), OS8),
    "da": (lambda: jah.DAHead(2, channels=CH),
           lambda c: tah.DAHead(c, 2, channels=CH), OS8),
    "psa": (lambda: jah.PSAHead(2, channels=CH, mask_size=(5, 5)),
            lambda c: tah.PSAHead(c, 2, channels=CH, mask_size=(5, 5)),
            OS8),
    "psa_odd_align": (
        lambda: jah.PSAHead(2, channels=CH, mask_size=(7, 5),
                            psa_type="distribute", **HR_WIRE),
        lambda c: tah.PSAHead(c, 2, channels=CH, mask_size=(7, 5),
                              psa_type="distribute", **HR_WIRE),
        [(8, 11, 9), (12, 6, 5), (16, 3, 3), (24, 2, 2)]),
    "psa_compact": (
        lambda: jah.PSAHead(2, channels=CH, mask_size=(3, 3),
                            psa_type="collect", compact=True),
        lambda c: tah.PSAHead(c, 2, channels=CH, mask_size=(3, 3),
                              psa_type="collect", compact=True),
        [(8, 12, 12), (12, 6, 6), (16, 6, 6), (24, 6, 6)]),
    "enc": (lambda: jah.EncHead(2, channels=CH, num_codes=8),
            lambda c: tah.EncHead(c, 2, channels=CH, num_codes=8), OS8),
    "enc_lateral": (
        lambda: jah.EncHead(1, channels=CH, num_codes=8, add_lateral=True),
        lambda c: tah.EncHead(c, 1, channels=CH, num_codes=8,
                              add_lateral=True), PYR),
}


@functools.lru_cache(maxsize=None)
def head_case(name):
    """(variables, features, cotangent, JAX results) of head ``name``: in
    float64 the train-mode logits, updated statistics, parameter and input
    gradients and dropout masks; in f32 the eval-mode logits. Each JAX
    program is compiled once per module."""
    jfn, _, stages = HEADS[name]
    rng = np.random.default_rng(sorted(HEADS).index(name))
    feats = [rng.normal(size=(2, h, w, c)).astype(np.float32)
             for c, h, w in stages]
    jmod = jfn()
    variables = numpy_variables(jmod, [jnp.asarray(f) for f in feats],
                                train=False, seed=1)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    if "codewords" in variables["params"]:
        p = dict(variables["params"])
        p["scale"] = -np.abs(p["scale"])
        variables = {**variables, "params": p}
    evl = jax.jit(lambda v, fs: jmod.apply(v, fs, train=False))(
        variables, [jnp.asarray(f) for f in feats])
    cot = rng.normal(size=evl.shape)
    key = jax.random.PRNGKey(3)
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                     variables)
        f64 = [jnp.asarray(f, jnp.float64) for f in feats]

        def loss(params, fs):
            out, upd = jmod.apply(
                {**v64, "params": params}, fs, train=True,
                mutable=["batch_stats"], rngs={"dropout": key})
            return jnp.sum(out * cot), (out, upd["batch_stats"])

        (_, (out, stats)), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(v64["params"], f64)
        masks = jax_dropout_masks(jmod, v64, (f64,), key)
        out, stats, gp, gx = jax.tree_util.tree_map(
            np.asarray, (out, stats, gp, gx))
    return (variables, feats, cot, out, stats, gp, gx, masks, evl)


def close64(got, want, floor=0.0):
    """Within rtol 1e-6 and atol 1e-6 of the reference's largest value (or
    ``floor``, if larger)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(
        got, want, rtol=1e-6,
        atol=max(1e-6 * np.abs(want).max(), floor, 1e-300))


def check_head_train(name):
    variables, feats, cot, out, stats, gp, gx, masks, _ = head_case(name)
    _, tfn, stages = HEADS[name]
    tmod = port(tfn([c for c, _, _ in stages]), variables).double().train()
    xs = [nchw(f).double().requires_grad_() for f in feats]
    tmasks = masks[:n_dropout(tmod)]
    assert all(not m.all() for m in tmasks)
    got = tmod(xs, *tmasks)
    close64(nhwc(got), out)
    sd = tmod.state_dict()
    for k, v in from_flax({"batch_stats": stats}).items():
        close64(sd[k], v.double().numpy())
    (got * nchw(cot).double()).sum().backward()
    ref = {k: v.double().numpy() for k, v in from_flax(
        {"params": jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), gp)}).items()}
    params = dict(tmod.named_parameters())
    assert sorted(params) == sorted(ref)
    top = max(np.abs(v).max() for v in ref.values())
    for k, p in params.items():
        if not np.any(ref[k]):
            assert p.grad is None, k
            continue
        close64(p.grad, ref[k], 1e-9 * top)
    for x, g in zip(xs, gx):
        if not np.any(g):
            assert x.grad is None or not x.grad.any()
            continue
        close64(nhwc(x.grad), g)


def check_head_eval(name):
    variables, feats, *_, evl = head_case(name)
    _, tfn, stages = HEADS[name]
    tmod = port(tfn([c for c, _, _ in stages]), variables).eval()
    with torch.no_grad():
        got = tmod([nchw(f) for f in feats])
    close(nhwc(got), evl)


# the conv/pyramid family here; the attention family in
# test_torch_port_zoo_attention.py (each file compiles its own cases)
CONV_HEADS = sorted(n for n in HEADS if n.split("_")[0] in
                    ("dsfcn", "aspp", "sep", "uper", "fpn"))
ATTENTION_HEADS = sorted(set(HEADS) - set(CONV_HEADS))


@pytest.mark.parametrize("name", CONV_HEADS)
def test_head_train_matches_jax(name):
    check_head_train(name)


@pytest.mark.parametrize("name", CONV_HEADS)
def test_head_eval_matches_jax(name):
    check_head_eval(name)


def test_point_sample_matches_jax():
    rng = np.random.default_rng(8)
    feat = rng.normal(size=(2, 5, 7, 3)).astype(np.float32)
    # inside, on the border and outside [0, 1]: zero padding beyond
    coords = rng.uniform(-0.2, 1.2, size=(2, 40, 2)).astype(np.float32)
    want = jph.point_sample(jnp.asarray(feat), jnp.asarray(coords))
    got = tph.point_sample(nchw(feat), torch.from_numpy(coords))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("src,dst", [((5, 7), (12, 9)), ((4, 4), (8, 8)),
                                     ((6, 9), (4, 5))])
def test_nearest_resize_matches_jax(src, dst):
    x = np.random.default_rng(9).normal(size=(1, *src, 2)).astype(np.float32)
    want = jnecks._nearest_resize(jnp.asarray(x), dst)
    got = tnecks.nearest_resize(nchw(x), dst)
    np.testing.assert_array_equal(nhwc(got), np.asarray(want))


@pytest.mark.parametrize("stages,num_outs", [
    ([(8, 16, 17), (12, 8, 9), (16, 4, 5), (24, 2, 3)], 4),
    ([(8, 16, 16), (12, 8, 8), (16, 3, 3)], 4),
    ([(8, 9, 9), (12, 5, 5), (16, 3, 3)], 5)])
def test_fpn_neck_matches_jax(stages, num_outs):
    rng = np.random.default_rng(10)
    feats = [rng.normal(size=(2, h, w, c)).astype(np.float32)
             for c, h, w in stages]
    jmod = jnecks.FPN(out_channels=CH, num_outs=num_outs)
    variables = numpy_variables(jmod, [jnp.asarray(f) for f in feats],
                                train=False)
    want = jax.jit(lambda v, fs: jmod.apply(v, fs, train=False))(
        variables, [jnp.asarray(f) for f in feats])
    tmod = port(tnecks.FPN([c for c, _, _ in stages], CH, num_outs),
                variables)
    with torch.no_grad():
        got = tmod([nchw(f) for f in feats])
    assert tmod.out_channels == [CH] * len(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        close(nhwc(g), w, 1e-6)


@pytest.mark.parametrize("points", [8196, 500])
def test_point_rend_refine_matches_jax(points):
    """Two subdivision steps on random FPN outputs and coarse logits: with
    the default budget of 8196 points every pixel of the 32 x 34 and
    64 x 68 maps is re-scored; with 500 the most uncertain ones, and the
    uncertainties have no ties (checked at the first step; the second
    step's come from the point head's outputs), so both frameworks pick
    the same pixels."""
    rng = np.random.default_rng(12)
    feats = [rng.normal(size=(2, 16, 17, 8)).astype(np.float32),
             rng.normal(size=(2, 8, 9, 8)).astype(np.float32)]
    coarse = rng.normal(size=(2, 16, 17, 2)).astype(np.float32)
    jhead = jph.PointHead(num_classes=2, channels=CH, num_fcs=3)
    coords0 = jnp.zeros((2, 4, 2))
    variables = numpy_variables(jhead, [jnp.asarray(f) for f in feats],
                                jnp.asarray(coarse), coords0, train=False)

    def refine(v, fs, c, n):
        return jph.point_rend_refine(
            lambda f, lg, xy: jhead.apply(v, f, lg, xy, train=False),
            fs, c, subdivision_steps=2, subdivision_num_points=n)
    want = jax.jit(refine, static_argnums=3)(
        variables, [jnp.asarray(f) for f in feats], jnp.asarray(coarse),
        points)
    thead = port(tph.PointHead([8, 8], 2, channels=CH), variables).eval()
    up = tph.resize(nchw(coarse), (32, 34))
    unc = tph.calculate_uncertainty(up.permute(0, 2, 3, 1)).flatten(1)
    assert all(len(torch.unique(r)) == r.numel() for r in unc)
    with torch.no_grad():
        got = tph.point_rend_refine(thead, [nchw(f) for f in feats],
                                    nchw(coarse), 2, points)
    close(nhwc(got), want, 1e-6)
    # the refine wrote over the upsampled logits where it re-scored
    assert not torch.allclose(got, tph.resize(up, (64, 68)))
