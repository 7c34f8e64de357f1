"""Model factory of the PyTorch/CUDA port (port of
``aadg_tpu/models/__init__.py:24-82`` for the ported models: DeepLabV3+,
UNet, SegFormer and the zoo segmentors of ``models/zoo``)."""

from __future__ import annotations

import functools
from typing import Callable, Optional

from torch import nn

from . import segformer
from .deeplab import DeepLabV3Plus
from .segformer import SegFormer
from .unet import UNet
from .zoo import builder as zoo_builder

_MODELS = {"deeplabv3+": DeepLabV3Plus, "unet": UNet, "segformer": SegFormer}


def class_parser(dataset: str) -> int:
    return {"rvs": 1, "optic": 2}[dataset]


def domain_parser(dataset: str) -> int:
    return {"optic": 3, "rvs": 3}[dataset]


def channel_parser(backbone: str) -> int:
    table = {"mobilenet_v2": 1280, "unet": 512,
             "mit_b0": 256, "mit_b1": 512, "mit_b2": 512, "mit_b3": 512}
    if backbone in table:
        return table[backbone]
    return zoo_builder.backbone_channels(backbone)


def _variant(cfg) -> str:
    return cfg.MODEL.BACKBONE or "mit_b1"


def _zoo(cfg) -> bool:
    """True for a zoo name; raises for a zoo backbone the builder does
    not know."""
    if cfg.MODEL.NAME not in zoo_builder.ZOO_ARCHS:
        return False
    zoo_builder.check(cfg.MODEL.NAME, cfg.MODEL.BACKBONE)
    return True


def model_class(cfg) -> type:
    """The class ``build_model`` makes for ``cfg`` (not for a zoo name)."""
    name = cfg.MODEL.NAME
    if name not in _MODELS:
        raise NotImplementedError(
            f"model {name} is not ported yet (ROADMAP queue 1, item 7c)")
    if name == "deeplabv3+" and cfg.MODEL.BACKBONE != "mobilenet_v2":
        raise NotImplementedError(
            f"backbone {cfg.MODEL.BACKBONE} is not ported yet (ROADMAP "
            "queue 1, item 7c)")
    return _MODELS[name]


def feature_dim(cfg) -> int:
    """The width of the pooled feature the discriminator reads."""
    if _zoo(cfg):
        return zoo_builder.feature_dim(cfg.MODEL.NAME, cfg.MODEL.BACKBONE)
    cls = model_class(cfg)
    if cls is SegFormer:
        return segformer.VARIANTS[_variant(cfg)][0][-1]
    return cls.feature_dim


def dropout_drawer(cfg, crop: int) -> Optional[Callable]:
    """``(n, generator) -> masks`` of one train-mode forward of ``n``
    crop x crop images, for a model with dropout (SegFormer, the zoo
    heads' dropouts); None for the others, which draw nothing."""
    if _zoo(cfg):
        return functools.partial(zoo_builder.draw_dropout,
                                 zoo_builder.dropout_shapes(
                                     cfg.MODEL.NAME, cfg.MODEL.BACKBONE,
                                     crop))
    if model_class(cfg) is not SegFormer:
        return None
    return functools.partial(segformer.draw_dropout, _variant(cfg),
                             float(cfg.MODEL.DROP_PATH_RATE), crop, crop)


def build_model(cfg, num_classes: int) -> nn.Module:
    """The segmentation model of ``cfg`` with ``num_classes`` outputs:
    ``model(x) -> (logits, pooled feature)``, NHWC. ``TPU.REMAT``
    checkpoints the blocks of DeepLabV3+'s encoder and of SegFormer's (the
    JAX UNet and zoo have no remat)."""
    if _zoo(cfg):
        return zoo_builder.build_segmentor(cfg.MODEL.NAME,
                                           cfg.MODEL.BACKBONE,
                                           num_classes)[0]
    cls = model_class(cfg)
    remat = bool(cfg.TPU.REMAT)
    if cls is UNet:
        return UNet(in_channels=3, out_channels=num_classes)
    if cls is SegFormer:
        return SegFormer(num_classes, _variant(cfg),
                         float(cfg.MODEL.DROP_PATH_RATE), remat)
    return DeepLabV3Plus(num_classes, remat=remat)
