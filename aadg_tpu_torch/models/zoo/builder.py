"""``MODEL.NAME``/``MODEL.BACKBONE`` -> zoo segmentor (port of
``aadg_tpu/models/zoo/builder.py`` for the backbones and heads the zoo
experiment files name: ``fcn``, ``pspnet``, ``lraspp`` and the ``ocrnet``
cascade over ResNetV1c-50, HRNet-W18, MobileNetV3 large/small and
UNet-S5-D16). Every other name of the JAX builder raises. The zoo is built
in f32 and without activation checkpointing, as the JAX builder does.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from .attention_heads import OCRHead
from .backbones import HRNet, MobileNetV3, ResNetV1c, UNetBackbone
from .heads import ClsSeg, FCNHead, LRASPPHead, PSPHead
from .segmentor import CascadeEncoderDecoder, EncoderDecoder

# every architecture name of the JAX builder (builder.py:92-95)
ZOO_ARCHS = ("fcn", "pspnet", "deeplabv3", "deeplabv3plus", "upernet",
             "sem_fpn", "lraspp", "nonlocal_net", "gcnet", "dnlnet",
             "ccnet", "annnet", "apcnet", "dmnet", "emanet", "danet",
             "psanet", "encnet", "ocrnet", "fast_scnn", "pointrend")

# backbone -> (constructor, width of the last feature)
BACKBONES = {
    "resnet50_v1c": (lambda: ResNetV1c(50), 2048),
    "hrnet_w18": (lambda: HRNet(18), 144),
    "mobilenet_v3_large": (lambda: MobileNetV3("large"), 160),
    "mobilenet_v3_small": (lambda: MobileNetV3("small"), 96),
    "unet_s5_d16": (lambda: UNetBackbone(), 64),
}

# arch -> decode-head constructor (mmseg config-family defaults)
HEADS = {
    "fcn": lambda chans, k, **w: FCNHead(chans, k, channels=512, **w),
    "pspnet": lambda chans, k, **w: PSPHead(chans, k, channels=512, **w),
    # a multi-input head: it reads its three stages whatever the backbone
    "lraspp": lambda chans, k, **_: LRASPPHead(chans, k, channels=128),
}


def _unported(kind: str, name: str) -> NotImplementedError:
    return NotImplementedError(
        f"zoo {kind} {name} is not ported yet (ROADMAP queue 1, item 7, "
        "step 2)")


def check(arch: str, backbone: str) -> None:
    """Raise for an architecture or backbone that is not ported."""
    if arch not in HEADS and arch != "ocrnet":
        raise _unported("architecture", arch)
    if backbone not in BACKBONES:
        raise _unported("backbone", backbone)


def backbone_channels(name: str) -> int:
    """The width of ``name``'s last feature (the pooled feature)."""
    if name not in BACKBONES:
        raise _unported("backbone", name)
    return BACKBONES[name][1]


def build_backbone(name: str) -> Tuple[nn.Module, int]:
    """(backbone module, last-feature width)."""
    backbone_channels(name)
    fn, ch = BACKBONES[name]
    return fn(), ch


def _wire(backbone: str) -> dict:
    """How a single-input head reads the backbone: mmseg's HRNet configs
    feed the stride-4 ``resize_concat`` of all four branches, its UNet
    configs the full-resolution decoder output (``in_index=4``)."""
    if backbone.startswith("hrnet"):
        return {"in_index": (0, 1, 2, 3), "input_transform": "resize_concat"}
    if backbone.startswith("unet"):
        return {"in_index": 4}
    return {}


def build_segmentor(arch: str, backbone: str,
                    num_classes: int) -> Tuple[nn.Module, int]:
    """(segmentor, pooled-feature width) for ``arch`` over ``backbone``."""
    check(arch, backbone)
    bb, feat_ch = build_backbone(backbone)
    chans = bb.out_channels
    wire = _wire(backbone)
    if arch == "ocrnet":
        # cascade: an FCN stage, then the OCR refiner
        fcn = FCNHead(chans, num_classes, channels=512, num_convs=1,
                      concat_input=False, **wire)
        ocr = OCRHead(chans, num_classes, channels=512, ocr_channels=256,
                      **wire)
        return CascadeEncoderDecoder(bb, fcn, (ocr,), feat_ch), feat_ch
    head = HEADS[arch](chans, num_classes, **wire)
    return EncoderDecoder(bb, head, feat_ch), feat_ch


def dropout_shapes(arch: str, backbone: str,
                   crop: int) -> List[Tuple[Tuple[int, int, int], float]]:
    """((h, w, channels), rate) of each classifier input (``ClsSeg``) of a
    crop x crop forward, in the order the heads run: read from an eval
    forward of the segmentor on the meta device, which computes shapes
    only."""
    with torch.device("meta"):
        model, _ = build_segmentor(arch, backbone, 1)
    model.eval()
    seen = []
    for m in model.modules():
        if isinstance(m, ClsSeg):
            m.register_forward_pre_hook(
                lambda mod, args: seen.append(
                    ((args[0].shape[2], args[0].shape[3], args[0].shape[1]),
                     mod.dropout_ratio)))
    with torch.no_grad():
        model(torch.zeros(1, crop, crop, 3, device="meta"))
    return seen


def draw_dropout(shapes, n: int, generator: torch.Generator):
    """The classifier dropout masks of one train-mode forward of ``n``
    images (``shapes`` from ``dropout_shapes``), on the generator's
    device: per classifier an (n, h, w, channels) bool keep mask, each
    element kept with probability 1 - rate."""
    dev = generator.device
    return tuple(torch.rand((n, *shape), generator=generator, device=dev)
                 < 1.0 - rate for shape, rate in shapes)
