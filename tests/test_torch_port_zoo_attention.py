"""The port's attention heads of slice 7
(``aadg_tpu_torch/models/zoo/attention_heads.py``: NL, GC, DNL, CC, ANN,
APC, DM, EMA, DA, PSA and Enc) against the JAX package's, f32 on the CPU,
at narrow widths, by the cases and criteria of
``test_torch_port_zoo_heads.py`` (train forward and gradients in float64
within 1e-6, eval in f32 within 1e-4); the parameters JAX leaves without
gradient; EMAHead's bases; ``psa_mask_attention`` on its own (outside
entries 0) and ``DCM`` with even filters within 1e-6 and 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aadg_tpu.models.zoo import attention_heads as jah
from aadg_tpu_torch.models.zoo import attention_heads as tah
from test_torch_port_zoo import close, nchw, nhwc, numpy_variables, port
from test_torch_port_zoo_heads import (ATTENTION_HEADS, CH, HEADS,
                                       check_head_eval, check_head_train,
                                       head_case)
from torch_port_helpers import few_torch_threads  # noqa: F401
from torch_port_helpers import _np


@pytest.mark.parametrize("name", ATTENTION_HEADS)
def test_attention_head_train_matches_jax(name):
    check_head_train(name)


@pytest.mark.parametrize("name", ATTENTION_HEADS)
def test_attention_head_eval_matches_jax(name):
    check_head_eval(name)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_no_gradient_parameters_are_the_jax_ones():
    """The parameters JAX's gradient leaves at exactly zero are the ones
    the module docstring names."""
    zero = {}
    for name in ("ema", "da", "enc"):
        gp = head_case(name)[5]
        zero[name] = sorted({p.rsplit("/", 1)[0] for p, v in _leaves(_np(gp))
                             if not np.any(v)})
    assert zero == {"ema": ["ema_mid_conv"],
                    "da": ["cam_cls/conv_seg", "pam_cls/conv_seg"],
                    "enc": ["se_layer"]}


def test_ema_bases_update_only_in_train():
    variables, feats, _, _, stats, *_ = head_case("ema")
    _, tfn, stages = HEADS["ema"]
    tmod = port(tfn([c for c, _, _ in stages]), variables)
    before = tmod.bases.clone()
    with torch.no_grad():
        tmod.eval()([nchw(f) for f in feats])
    assert torch.equal(tmod.bases, before)
    assert not np.allclose(np.asarray(stats["bases"]),
                           np.asarray(variables["batch_stats"]["bases"]))
    norms = np.linalg.norm(np.asarray(stats["bases"]), axis=0)
    assert np.all(norms < 1.0 + 1e-5)


@pytest.mark.parametrize("mode", ["collect", "distribute"])
@pytest.mark.parametrize("hw,mask", [((4, 5), (5, 3)), ((3, 3), (9, 9))])
def test_psa_mask_attention_matches_jax(mode, hw, mask):
    h, w = hw
    z = np.random.default_rng(7).normal(
        size=(2, h, w, mask[0] * mask[1])).astype(np.float32)
    want = jah.psa_mask_attention(jnp.asarray(z), mask, mode)
    got = tah.psa_mask_attention(nchw(z), mask, mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    if mask == (5, 3):
        assert (got == 0).any()   # entries outside the window stay 0


def test_dcm_even_filters_match_jax():
    x = np.random.default_rng(11).normal(size=(2, 6, 7, 8)).astype(
        np.float32)
    for k in (2, 3, 4):
        jmod = jah.DCM(k, CH, fusion=False)
        variables = numpy_variables(jmod, jnp.asarray(x), train=False)
        want = jax.jit(lambda v, a: jmod.apply(v, a, train=False))(
            variables, jnp.asarray(x))
        tmod = port(tah.DCM(8, k, CH, fusion=False), variables).eval()
        with torch.no_grad():
            close(nhwc(tmod(nchw(x))), want)
