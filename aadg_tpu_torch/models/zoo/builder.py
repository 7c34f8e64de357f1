"""``MODEL.NAME``/``MODEL.BACKBONE`` -> zoo segmentor (port of
``aadg_tpu/models/zoo/builder.py``): every architecture of ``ZOO_ARCHS``
over every backbone of the JAX builder: ResNetV1c-50/101, ResNeXt-50/101,
ResNeSt-50/101, HRNet-W18/32/48, MobileNetV3 large/small, Fast-SCNN,
CGNet and UNet-S5-D16. The zoo is built in f32 and without activation
checkpointing, as the JAX builder does.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from . import attention_heads as ah
from . import heads as hd
from .backbones import (CGNet, FastSCNN, HRNet, MobileNetV3, ResNeSt,
                        ResNeXt, ResNetV1c, UNetBackbone)
from .necks import FPN
from .point_head import PointHead
from .segmentor import (CascadeEncoderDecoder, EncoderDecoder,
                        PointRendSegmentor)

# every architecture name of the JAX builder (builder.py:92-95)
ZOO_ARCHS = ("fcn", "pspnet", "deeplabv3", "deeplabv3plus", "upernet",
             "sem_fpn", "lraspp", "nonlocal_net", "gcnet", "dnlnet",
             "ccnet", "annnet", "apcnet", "dmnet", "emanet", "danet",
             "psanet", "encnet", "ocrnet", "fast_scnn", "pointrend")

# backbone -> (constructor, width of the last feature)
BACKBONES = {
    "resnet50_v1c": (lambda: ResNetV1c(50), 2048),
    "resnet101_v1c": (lambda: ResNetV1c(101), 2048),
    "resnext50": (lambda: ResNeXt(50), 2048),
    "resnext101": (lambda: ResNeXt(101), 2048),
    "resnest50": (lambda: ResNeSt(50), 2048),
    "resnest101": (lambda: ResNeSt(101), 2048),
    "hrnet_w18": (lambda: HRNet(18), 144),
    "hrnet_w32": (lambda: HRNet(32), 256),
    "hrnet_w48": (lambda: HRNet(48), 384),
    "mobilenet_v3_large": (lambda: MobileNetV3("large"), 160),
    "mobilenet_v3_small": (lambda: MobileNetV3("small"), 96),
    "fast_scnn": (lambda: FastSCNN(), 128),
    "cgnet": (lambda: CGNet(), 256),
    "unet_s5_d16": (lambda: UNetBackbone(), 64),
}
# archs whose pooled feature is the FPN neck's, not the backbone's
FPN_WIDTH = 256
_FPN_ARCHS = ("sem_fpn", "pointrend")

# arch -> (decode-head constructor (stage widths, classes, **wiring),
# whether it reads one input and so takes the HRNet/UNet wiring)
HEADS = {
    "fcn": (lambda c, k, **w: hd.FCNHead(c, k, channels=512, **w), True),
    "pspnet": (lambda c, k, **w: hd.PSPHead(c, k, channels=512, **w), True),
    "deeplabv3": (lambda c, k, **w: hd.ASPPHead(c, k, channels=512, **w),
                  True),
    "deeplabv3plus": (lambda c, k, **w: hd.DepthwiseSeparableASPPHead(
        c, k, channels=512, **w), True),
    "upernet": (lambda c, k: hd.UPerHead(c, k, channels=512), False),
    "lraspp": (lambda c, k: hd.LRASPPHead(c, k, channels=128), False),
    "nonlocal_net": (lambda c, k, **w: ah.NLHead(c, k, channels=512, **w),
                     True),
    "gcnet": (lambda c, k, **w: ah.GCHead(c, k, channels=512, **w), True),
    "dnlnet": (lambda c, k, **w: ah.DNLHead(c, k, channels=512, **w), True),
    "ccnet": (lambda c, k, **w: ah.CCHead(c, k, channels=512, **w), True),
    "annnet": (lambda c, k: ah.ANNHead(c, k, channels=512), False),
    "apcnet": (lambda c, k, **w: ah.APCHead(c, k, channels=512, **w), True),
    "dmnet": (lambda c, k, **w: ah.DMHead(c, k, channels=512, **w), True),
    "emanet": (lambda c, k, **w: ah.EMAHead(c, k, channels=256, **w), True),
    "danet": (lambda c, k, **w: ah.DAHead(c, k, channels=512, **w), True),
    "psanet": (lambda c, k, **w: ah.PSAHead(c, k, channels=512, **w), True),
    "encnet": (lambda c, k: ah.EncHead(c, k, channels=512), False),
    "fast_scnn": (lambda c, k, **w: hd.DepthwiseSeparableFCNHead(
        c, k, channels=128, **{"in_index": 2, **w}), True),
}


def check(arch: str, backbone: str) -> None:
    """Raise for a name the builder does not know."""
    if arch not in ZOO_ARCHS:
        raise KeyError(f"unknown zoo architecture {arch}")
    backbone_channels(backbone)


def backbone_channels(name: str) -> int:
    """The width of ``name``'s last feature."""
    if name not in BACKBONES:
        raise KeyError(f"unknown zoo backbone {name}")
    return BACKBONES[name][1]


def feature_dim(arch: str, backbone: str) -> int:
    """The width of the segmentor's pooled feature (the discriminator's
    input): the FPN's for ``sem_fpn`` and ``pointrend``, else the
    backbone's last feature's."""
    check(arch, backbone)
    return FPN_WIDTH if arch in _FPN_ARCHS else backbone_channels(backbone)


def build_backbone(name: str) -> Tuple[nn.Module, int]:
    """(backbone module, last-feature width)."""
    ch = backbone_channels(name)
    return BACKBONES[name][0](), ch


def _wire(backbone: str) -> dict:
    """How a single-input head reads the backbone: mmseg's HRNet configs
    feed the stride-4 ``resize_concat`` of all four branches, its UNet
    configs the full-resolution decoder output (``in_index=4``)."""
    if backbone.startswith("hrnet"):
        return {"in_index": (0, 1, 2, 3), "input_transform": "resize_concat"}
    if backbone.startswith("unet"):
        return {"in_index": 4}
    return {}


def backbone_strides(name: str, size: int = 64) -> Tuple[int, ...]:
    """The true output strides of backbone ``name``, read from an eval
    forward of a size x size image on the meta device (shapes only)."""
    with torch.device("meta"):
        bb, _ = build_backbone(name)
    bb.eval()
    with torch.no_grad():
        feats = bb(torch.zeros(1, 3, size, size, device="meta"))
    return tuple(size // max(1, f.shape[2]) for f in feats)


def fpn_strides(name: str, num_outs: int) -> Tuple[int, ...]:
    """Strides of the FPN neck's outputs over backbone ``name``: the
    backbone's, extended by stride-2 levels up to ``num_outs``."""
    strides = list(backbone_strides(name))
    while len(strides) < num_outs:
        strides.append(strides[-1] * 2)
    return tuple(strides[:num_outs])


def build_segmentor(arch: str, backbone: str,
                    num_classes: int) -> Tuple[nn.Module, int]:
    """(segmentor, pooled-feature width) for ``arch`` over ``backbone``."""
    feat_ch = feature_dim(arch, backbone)
    strides = fpn_strides(backbone, 4) if arch in _FPN_ARCHS else None
    bb, _ = build_backbone(backbone)
    chans = bb.out_channels
    wire = _wire(backbone)
    if arch in _FPN_ARCHS:
        neck = FPN(chans, FPN_WIDTH, 4)
        head = hd.FPNHead(neck.out_channels, num_classes, channels=128,
                          feature_strides=strides)
        if arch == "sem_fpn":
            return EncoderDecoder(bb, head, feat_ch, neck), feat_ch
        point = PointHead(neck.out_channels, num_classes, channels=256,
                          num_fcs=3, in_index=(0,))
        return PointRendSegmentor(bb, neck, head, point, feat_ch), feat_ch
    if arch == "ocrnet":
        # cascade: an FCN stage, then the OCR refiner
        fcn = hd.FCNHead(chans, num_classes, channels=512, num_convs=1,
                         concat_input=False, **wire)
        ocr = ah.OCRHead(chans, num_classes, channels=512, ocr_channels=256,
                         **wire)
        return CascadeEncoderDecoder(bb, fcn, (ocr,), feat_ch), feat_ch
    make, single_input = HEADS[arch]
    head = make(chans, num_classes, **wire) if single_input else make(
        chans, num_classes)
    return EncoderDecoder(bb, head, feat_ch), feat_ch


def _dropout_sites(model: nn.Module):
    return [m for m in model.modules()
            if isinstance(m, (hd.ClsSeg, hd.Dropout))]


def dropout_shapes(arch: str, backbone: str,
                   crop: int) -> List[Tuple[Tuple[int, int, int], float]]:
    """((h, w, channels), rate) of the input of each dropout of a train
    forward on a crop x crop image (each classifier's ``ClsSeg``, and
    ANN's ``Dropout``), in the order they run: read from an eval forward
    of the segmentor on the meta device, which computes shapes only and
    runs the same dropouts (PointRend's subdivision runs only in eval and
    has none)."""
    with torch.device("meta"):
        model, _ = build_segmentor(arch, backbone, 1)
    model.eval()
    seen = []
    for m in _dropout_sites(model):
        m.register_forward_pre_hook(
            lambda mod, args: seen.append(
                ((args[0].shape[2], args[0].shape[3], args[0].shape[1]),
                 mod.dropout_ratio)))
    with torch.no_grad():
        model(torch.zeros(1, crop, crop, 3, device="meta"))
    return seen


def draw_dropout(shapes, n: int, generator: torch.Generator):
    """The dropout masks of one train-mode forward of ``n`` images
    (``shapes`` from ``dropout_shapes``), on the generator's device: per
    dropout an (n, h, w, channels) bool keep mask, each element kept with
    probability 1 - rate."""
    dev = generator.device
    return tuple(torch.rand((n, *shape), generator=generator, device=dev)
                 < 1.0 - rate for shape, rate in shapes)
