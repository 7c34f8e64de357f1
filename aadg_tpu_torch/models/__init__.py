"""Model factory of the PyTorch/CUDA port (port of
``aadg_tpu/models/__init__.py:24-60`` for the two ported models)."""

from __future__ import annotations

from torch import nn

from .deeplab import DeepLabV3Plus
from .unet import UNet

_MODELS = {"deeplabv3+": DeepLabV3Plus, "unet": UNet}


def class_parser(dataset: str) -> int:
    return {"rvs": 1, "optic": 2}[dataset]


def domain_parser(dataset: str) -> int:
    return {"optic": 3, "rvs": 3}[dataset]


def channel_parser(backbone: str) -> int:
    return {"mobilenet_v2": 1280, "unet": 512}[backbone]


def model_class(cfg) -> type:
    """The class ``build_model`` makes for ``cfg``; its ``feature_dim`` is
    the width of the pooled feature the discriminator reads."""
    name = cfg.MODEL.NAME
    if name not in _MODELS:
        raise NotImplementedError(
            f"model {name} is not ported yet (ROADMAP queue 1, item 7)")
    if name == "deeplabv3+" and cfg.MODEL.BACKBONE != "mobilenet_v2":
        raise NotImplementedError(
            f"backbone {cfg.MODEL.BACKBONE} is not ported yet (ROADMAP "
            "queue 1, item 7)")
    return _MODELS[name]


def build_model(cfg, num_classes: int) -> nn.Module:
    """The segmentation model of ``cfg`` with ``num_classes`` outputs:
    ``model(x) -> (logits, pooled feature)``, NHWC."""
    cls = model_class(cfg)
    if cls is UNet:
        return UNet(in_channels=3, out_channels=num_classes)
    return DeepLabV3Plus(num_classes)
