"""The wiring of the zoo's segmentors over the port's new backbones
(ResNeSt-50/101, Fast-SCNN, CGNet) against the JAX builder's: over those
four backbones x ``fcn``, ``upernet``, ``sem_fpn``, ``ocrnet`` and
``pointrend``, the port builds a pair (on the meta device) if and only if
JAX does (``jax.eval_shape`` of one train-mode ``init``), with equal
logits shapes, pooled width (the discriminator's input) and dropout
shapes at crop 64. Fast-SCNN's strides (8, 32, 8) are not monotone;
whatever JAX's ``_fpn_strides`` makes of them for ``sem_fpn`` and
``pointrend``, the port makes the same. Shapes only: nothing is computed.
"""

import jax
import jax.numpy as jnp
import pytest
import torch
from flax import linen as fnn

from aadg_tpu.models.zoo import builder as jbuilder
from aadg_tpu_torch.models.zoo import builder as tbuilder

NEW = ("resnest50", "resnest101", "fast_scnn", "cgnet")
WIRED_ARCHS = ("fcn", "upernet", "sem_fpn", "ocrnet", "pointrend")


def _jax_wiring(arch, backbone, crop=64):
    """(logits shape, pooled width, [((h, w, channels), rate)] of each
    Dropout) of a train-mode init of JAX's segmentor, shapes only (one
    trace)."""
    model, feat = jbuilder.build_segmentor(arch, backbone, 2)
    seen = []

    def record(next_fun, a, kw, context):
        if (context.method_name == "__call__"
                and isinstance(context.module, fnn.Dropout)):
            seen.append((tuple(a[0].shape[1:]), context.module.rate))
        return next_fun(*a, **kw)

    def run(x):
        with fnn.intercept_methods(record):
            return model.init_with_output(
                {"params": jax.random.PRNGKey(0),
                 "dropout": jax.random.PRNGKey(1)}, x, train=True)[0][0]
    logits = jax.eval_shape(run, jax.ShapeDtypeStruct((2, crop, crop, 3),
                                                      jnp.float32))
    return tuple(logits.shape), feat, seen


def _port_wiring(arch, backbone, crop=64):
    with torch.device("meta"):
        model, feat = tbuilder.build_segmentor(arch, backbone, 2)
    with torch.no_grad():
        logits, _ = model.eval()(torch.zeros(2, crop, crop, 3,
                                             device="meta"))
    return tuple(logits.shape), feat, tbuilder.dropout_shapes(
        arch, backbone, crop)


@pytest.mark.parametrize("arch", WIRED_ARCHS)
@pytest.mark.parametrize("backbone", NEW)
def test_new_backbone_wiring_matches_jax(arch, backbone):
    try:
        want = _jax_wiring(arch, backbone)
    except Exception as e:          # the JAX builder refuses the pair
        with pytest.raises(type(e)):
            _port_wiring(arch, backbone)
        return
    got = _port_wiring(arch, backbone)
    assert got[0] == want[0] == (2, 64, 64, 2)
    assert got[1] == want[1] == tbuilder.feature_dim(arch, backbone)
    assert [(tuple(s), pytest.approx(r)) for s, r in got[2]] == want[2]
    assert got[1] == (256 if arch in ("sem_fpn", "pointrend") else {
        "resnest50": 2048, "resnest101": 2048, "fast_scnn": 128,
        "cgnet": 256}[backbone])
