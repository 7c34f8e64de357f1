"""The port's zoo backbones (``aadg_tpu_torch/models/zoo/backbones.py``)
against the JAX package's (``aadg_tpu/models/zoo/backbones.py``), f32 on
the CPU, with weights and inputs drawn with numpy from a seed
(``test_torch_port_zoo.numpy_variables``) and the JAX modules jitted.

Each backbone (ResNetV1c-50, ResNeXt-50 (32x4d), HRNet-W18/W32/W48,
MobileNetV3 large and small, UNet-S5-D16) runs at full width on 2 images
of 64 x 64 (the HRNets cut to one exchange unit per stage and 2 blocks
per branch, which keeps every branch count and fusion), in train mode (batch statistics, and the
updated running statistics) and in eval mode: every output within rtol
1e-4 and atol 1e-4 of its largest magnitude, 2e-4 in train mode, where
BatchNorm over 2 small images amplifies f32 rounding through ResNet-50's
16 blocks (measured 1.2e-4). The 101-layer ResNetV1c and ResNeXt differ
from the 50-layer ones only in their third stage's block count; their
trees are held to JAX's in ``test_torch_port_zoo.py``'s weight maps.
``DeconvModule`` (not on the configured UNet,
which upsamples with ``InterpConv``) within 1e-4; ``weights.from_flax``
maps flax's unflipped ConvTranspose kernel.
"""

import jax
import numpy as np
import pytest
import torch

from aadg_tpu.models.zoo import backbones as jbb
from aadg_tpu_torch.models.zoo import backbones as tbb
from test_torch_port_zoo import (check_stats, close, japply, nchw, nhwc,
                                 numpy_variables, port)
from torch_port_helpers import few_torch_threads  # noqa: F401


# -- backbones --------------------------------------------------------------

BACKBONES = {
    "resnet50_v1c": (lambda: jbb.ResNetV1c(50), lambda: tbb.ResNetV1c(50)),
    "resnext50": (lambda: jbb.ResNeXt(50), lambda: tbb.ResNeXt(50)),
    "hrnet_w18": (lambda: jbb.HRNet(18, (1, 1, 1), 2),
                  lambda: tbb.HRNet(18, (1, 1, 1), 2)),
    "hrnet_w32": (lambda: jbb.HRNet(32, (1, 1, 1), 2),
                  lambda: tbb.HRNet(32, (1, 1, 1), 2)),
    "hrnet_w48": (lambda: jbb.HRNet(48, (1, 1, 1), 2),
                  lambda: tbb.HRNet(48, (1, 1, 1), 2)),
    "mobilenet_v3_large": (lambda: jbb.MobileNetV3("large"),
                           lambda: tbb.MobileNetV3("large")),
    "mobilenet_v3_small": (lambda: jbb.MobileNetV3("small"),
                           lambda: tbb.MobileNetV3("small")),
    "unet_s5_d16": (lambda: jbb.UNetBackbone(), lambda: tbb.UNetBackbone()),
}


@pytest.fixture(scope="module")
def backbone_weights():
    cache = {}

    def get(name):
        if name not in cache:
            jmod = BACKBONES[name][0]()
            x = np.random.default_rng(4).normal(size=(2, 64, 64, 3)).astype(
                np.float32)
            cache[name] = (jmod, numpy_variables(jmod, x, train=False), x)
        return cache[name]
    return get


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", sorted(BACKBONES))
def test_backbone_matches_jax(backbone_weights, name, train):
    jmod, variables, x = backbone_weights(name)
    tmod = port(BACKBONES[name][1](), variables).train(train)
    assert tmod.out_channels == [f.shape[-1] for f in jax.eval_shape(
        lambda: jmod.apply(variables, x, train=False))]
    if train:
        want, upd = japply(jmod, variables, x, train=True)
    else:
        want = japply(jmod, variables, x, train=False)
    with torch.no_grad():
        got = tmod(nchw(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        close(nhwc(g), w, 2e-4 if train else 1e-4)
    if train:
        check_stats(tmod, upd)


def test_deconv_module_matches_jax():
    jmod = jbb.DeconvModule(8)
    x = np.random.default_rng(5).normal(size=(2, 5, 6, 4)).astype(
        np.float32)
    variables = numpy_variables(jmod, x, train=False)
    want, upd = japply(jmod, variables, x, train=True)
    tmod = port(tbb.DeconvModule(4, 8), variables).train()
    got = tmod(nchw(x))
    assert got.shape == (2, 8, 10, 12)
    close(nhwc(got), want)
    check_stats(tmod, upd)
