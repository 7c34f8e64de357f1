"""Convert torch checkpoints in their source naming to the port's
state_dict naming (the port's copy of the source-name maps of the JAX
package's ``tools/convert_torch_weights.py``).

The reference initializes encoders from ImageNet; the repository holds no
such weights, so this converts a ``.pth`` that a user brings. Each map
gives what the JAX tool gives, a tree in flax naming (``{"params": ...,
"batch_stats": ...}``, numpy leaves); ``weights.from_flax`` turns it into
the port's state_dict keys, relative to the module the weights belong in,
and ``main`` writes that dict with ``torch.save``.
``utils/pretrained.py::load_pretrained`` grafts it into a built model
(config key ``TPU.PRETRAINED``).

  arch                 source naming              port module
  ------------------   ------------------------   ----------------------------
  mobilenet_v2         torchvision `features.N`   models.mobilenetv2.MobileNetV2Encoder
  resnet50/101/152     mmcv ResNetV1c             models.zoo.backbones.ResNetV1c
  resnext50/101        mmcv ResNeXt (32x4d/8d)    models.zoo.backbones.ResNeXt
  resnest50/101        mmcv/mmseg ResNeSt         models.zoo.backbones.ResNeSt
  hrnet18/32/48        mmcv HRNetV2-W*            models.zoo.backbones.HRNet
  mobilenet_v3_small/  torchvision MNv3           models.zoo.backbones.MobileNetV3
  mobilenet_v3_large
  mit_b0..b5           SegFormer official MiT     models.segformer.MixTransformer
  unet_s5_d16          mmseg UNet                 models.zoo.backbones.UNetBackbone

Usage:
    python -m aadg_tpu_torch.convert_weights --arch resnest101 in.pth out.pt

A whole mmseg segmentor checkpoint (backbone + decode head) converts into
the weights of ``models/zoo/builder.py::build_segmentor``, grafted at the
model's root:

    python -m aadg_tpu_torch.convert_weights --segmentor pspnet \\
        --backbone resnet50_v1c pspnet_r50.pth out.pt

Auxiliary heads (train-time deep supervision) are dropped and reported.
The mobilenet_v3 maps read TORCHVISION naming; mmseg's own MNv3
checkpoints (mmcv layer naming) are not mapped. The source file is read
with ``torch.load(weights_only=True)``; a checkpoint that needs a full
unpickle (an mmcv ``meta`` holding other objects) is refused, not loaded
unsafely.

Mapping notes (torch -> flax):
- Conv2d.weight (O,I,kH,kW) -> Conv.kernel (kH,kW,I,O); depthwise
  (O,1,kH,kW) -> (kH,kW,1,O); grouped (O,I/g,kH,kW) -> (kH,kW,I/g,O).
- Linear.weight (O,I) and 1x1-Conv-as-fc (O,I,1,1) -> Dense.kernel (I,O).
- BatchNorm2d.{weight,bias,running_mean,running_var} ->
  BatchNorm.{scale,bias} + batch_stats.{mean,var}; LayerNorm.{weight,bias}
  -> LayerNorm.{scale,bias}.
- ResNeSt is converted for groups=1 (the mmseg config family); SplAtConv2d
  fc layouts for groups>1 would need a radix/group permutation.
"""

import argparse
import pickle
import sys

import numpy as np
import torch

from .models.segformer import VARIANTS
from .weights import from_flax


def convert_conv(w):
    """torch OIHW (incl. depthwise/grouped O,I/g,kH,kW) -> flax HWIO."""
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def convert_dense(w):
    """torch Linear (O,I) or 1x1 conv-as-fc (O,I,1,1) -> Dense (I,O)."""
    w = np.asarray(w)
    if w.ndim == 4:
        w = w[:, :, 0, 0]
    return np.transpose(w)


def _put(tree, path, value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = np.asarray(value)


class _Mapper:
    """Accumulates (params, batch_stats) while consuming a torch
    state_dict; raises KeyError with the missing torch key on mismatch."""

    def __init__(self, sd):
        self.sd = sd
        self.params = {}
        self.stats = {}

    def conv(self, dst, key, bias=False):
        _put(self.params, dst + ["kernel"], convert_conv(self.sd[key]))
        if bias:
            _put(self.params, dst + ["bias"],
                 self.sd[key[: -len("weight")] + "bias"])

    def dense(self, dst, prefix):
        _put(self.params, dst + ["kernel"],
             convert_dense(self.sd[prefix + ".weight"]))
        _put(self.params, dst + ["bias"], self.sd[prefix + ".bias"])

    def bn(self, dst, prefix):
        _put(self.params, dst + ["scale"], self.sd[prefix + ".weight"])
        _put(self.params, dst + ["bias"], self.sd[prefix + ".bias"])
        _put(self.stats, dst + ["mean"], self.sd[prefix + ".running_mean"])
        _put(self.stats, dst + ["var"], self.sd[prefix + ".running_var"])

    def ln(self, dst, prefix):
        _put(self.params, dst + ["scale"], self.sd[prefix + ".weight"])
        _put(self.params, dst + ["bias"], self.sd[prefix + ".bias"])

    def done(self):
        return self.params, self.stats


# ---------------------------------------------------------------------------
# MobileNetV2 (torchvision) — the flagship model's encoder
# ---------------------------------------------------------------------------

def convert(state_dict):
    """torchvision MobileNetV2 `features.N` -> MobileNetV2Encoder
    (ConvBNReLU6_0, InvertedResidual_0..16, ConvBNReLU6_1)."""
    params = {}
    stats = {}

    # group torch keys by the features.N prefix
    groups = {}
    for k, v in state_dict.items():
        if not k.startswith("features."):
            continue
        idx = int(k.split(".")[1])
        groups.setdefault(idx, {})[k.split(".", 2)[2]] = v

    def conv_bn(src, dst_prefix, conv_key="0", bn_key="1"):
        _put(params, dst_prefix + ["Conv_0", "kernel"],
             convert_conv(src[f"{conv_key}.weight"]))
        _put(params, dst_prefix + ["BatchNorm_0", "scale"],
             src[f"{bn_key}.weight"])
        _put(params, dst_prefix + ["BatchNorm_0", "bias"],
             src[f"{bn_key}.bias"])
        _put(stats, dst_prefix + ["BatchNorm_0", "mean"],
             src[f"{bn_key}.running_mean"])
        _put(stats, dst_prefix + ["BatchNorm_0", "var"],
             src[f"{bn_key}.running_var"])

    conv_bn(groups[0], ["ConvBNReLU6_0"])
    for i in range(1, 18):
        g = groups[i]
        dst = [f"InvertedResidual_{i - 1}"]
        sub = 0
        # expand conv is absent for the first block (t=1). In torchvision
        # both layouts start with a ConvBNReLU at conv.0 (expand 1x1 or
        # the depthwise), so the discriminator is the index of the final
        # BatchNorm: conv.3 with expand, conv.2 without.
        if "conv.3.running_mean" in g:
            conv_bn({k[len("conv.0."):]: v for k, v in g.items()
                     if k.startswith("conv.0.")},
                    dst + [f"ConvBNReLU6_{sub}"])
            sub += 1
            dw_prefix = "conv.1."
            pw_idx = 2
        else:
            dw_prefix = "conv.0."
            pw_idx = 1
        conv_bn({k[len(dw_prefix):]: v for k, v in g.items()
                 if k.startswith(dw_prefix)}, dst + [f"ConvBNReLU6_{sub}"])
        _put(params, dst + ["Conv_0", "kernel"],
             convert_conv(g[f"conv.{pw_idx}.weight"]))
        _put(params, dst + ["BatchNorm_0", "scale"],
             g[f"conv.{pw_idx + 1}.weight"])
        _put(params, dst + ["BatchNorm_0", "bias"],
             g[f"conv.{pw_idx + 1}.bias"])
        _put(stats, dst + ["BatchNorm_0", "mean"],
             g[f"conv.{pw_idx + 1}.running_mean"])
        _put(stats, dst + ["BatchNorm_0", "var"],
             g[f"conv.{pw_idx + 1}.running_var"])
    conv_bn(groups[18], ["ConvBNReLU6_1"])
    return params, stats


# ---------------------------------------------------------------------------
# ResNetV1c / ResNeXt / ResNeSt (mmcv naming: deep stem + layerN.B blocks)
# ---------------------------------------------------------------------------

_RESNET_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def convert_resnet(state_dict, depth=50, family="resnet"):
    """mmcv ResNetV1c/ResNeXt/ResNeSt state_dict -> zoo ResNetV1c/ResNeSt.

    `stem.{0,3,6}` convs + `stem.{1,4,7}` BNs; `layerS.B.{conv,bn}{1,2,3}`;
    `downsample.{0,1}` (stride-conv shortcut) or `downsample.{1,2}`
    (avg_down: AvgPool at 0). ResNeSt's `conv2` is SplAtConv2d
    (`conv/bn0/fc1/bn1/fc2`, fcs are 1x1 convs -> Dense)."""
    m = _Mapper(state_dict)
    for i, ci in enumerate((0, 3, 6)):
        m.conv([f"stem{i}"], f"stem.{ci}.weight")
        m.bn([f"stem_bn{i}"], f"stem.{ci + 1}")
    for s in range(4):
        for b in range(_RESNET_BLOCKS[depth][s]):
            p = f"layer{s + 1}.{b}"
            dst = [f"layer{s + 1}_{b}"]
            m.conv(dst + ["conv1"], p + ".conv1.weight")
            m.bn(dst + ["bn1"], p + ".bn1")
            if family == "resnest":
                m.conv(dst + ["conv2", "conv"], p + ".conv2.conv.weight")
                m.bn(dst + ["conv2", "bn0"], p + ".conv2.bn0")
                m.dense(dst + ["conv2", "fc1"], p + ".conv2.fc1")
                m.bn(dst + ["conv2", "bn1"], p + ".conv2.bn1")
                m.dense(dst + ["conv2", "fc2"], p + ".conv2.fc2")
            else:
                m.conv(dst + ["conv2"], p + ".conv2.weight")
                m.bn(dst + ["bn2"], p + ".bn2")
            m.conv(dst + ["conv3"], p + ".conv3.weight")
            m.bn(dst + ["bn3"], p + ".bn3")
            if p + ".downsample.0.weight" in state_dict:
                m.conv(dst + ["down_conv"], p + ".downsample.0.weight")
                m.bn(dst + ["down_bn"], p + ".downsample.1")
            elif p + ".downsample.1.weight" in state_dict:  # avg_down
                m.conv(dst + ["down_conv"], p + ".downsample.1.weight")
                m.bn(dst + ["down_bn"], p + ".downsample.2")
    return m.done()


# ---------------------------------------------------------------------------
# HRNet (mmcv naming: stem convs, layer1, transitions, stageS.M modules)
# ---------------------------------------------------------------------------

def convert_hrnet(state_dict, stage_modules=(1, 4, 3), num_blocks=4):
    """mmcv HRNetV2 state_dict -> zoo HRNet. Transitions to an existing
    branch are Sequential(conv,bn,relu) -> `transitionT.I.{0,1}`; to a NEW
    branch Sequential(Sequential(conv,bn,relu)) -> `transitionT.I.0.{0,1}`.
    Fuse layers: j>i upsample `.{0,1}`; j<i stride-conv chain `.K.{0,1}`."""
    m = _Mapper(state_dict)
    for i, (c, b) in enumerate((("conv1", "bn1"), ("conv2", "bn2"))):
        m.conv([f"stem{i}"], f"{c}.weight")
        m.bn([f"stem_bn{i}"], b)
    for b in range(4):
        p, dst = f"layer1.{b}", [f"layer1_{b}"]
        for k in (1, 2, 3):
            m.conv(dst + [f"conv{k}"], f"{p}.conv{k}.weight")
            m.bn(dst + [f"bn{k}"], f"{p}.bn{k}")
        if p + ".downsample.0.weight" in state_dict:
            m.conv(dst + ["down_conv"], p + ".downsample.0.weight")
            m.bn(dst + ["down_bn"], p + ".downsample.1")
    m.conv(["transition1_0", "conv"], "transition1.0.0.weight")
    m.bn(["transition1_0", "bn"], "transition1.0.1")
    m.conv(["transition1_1", "conv"], "transition1.1.0.0.weight")
    m.bn(["transition1_1", "bn"], "transition1.1.0.1")
    for stage, n_mod in enumerate(stage_modules):
        s = n_br = stage + 2
        for mod in range(n_mod):
            base, dmod = f"stage{s}.{mod}", [f"stage{s}_module{mod}"]
            for i in range(n_br):
                for b in range(num_blocks):
                    p = f"{base}.branches.{i}.{b}"
                    dst = dmod + [f"branch{i}_block{b}"]
                    for k in (1, 2):
                        m.conv(dst + [f"conv{k}"], f"{p}.conv{k}.weight")
                        m.bn(dst + [f"bn{k}"], f"{p}.bn{k}")
            for i in range(n_br):
                for j in range(n_br):
                    f = f"{base}.fuse_layers.{i}.{j}"
                    if j > i:
                        m.conv(dmod + [f"fuse_{i}_{j}_conv"],
                               f + ".0.weight")
                        m.bn(dmod + [f"fuse_{i}_{j}_bn"], f + ".1")
                    elif j < i:
                        for k in range(i - j):
                            m.conv(dmod + [f"fuse_{i}_{j}_conv{k}"],
                                   f + f".{k}.0.weight")
                            m.bn(dmod + [f"fuse_{i}_{j}_bn{k}"],
                                 f + f".{k}.1")
        if stage < len(stage_modules) - 1:
            m.conv([f"transition{s}_{n_br}", "conv"],
                   f"transition{s}.{n_br}.0.0.weight")
            m.bn([f"transition{s}_{n_br}", "bn"],
                 f"transition{s}.{n_br}.0.1")
    return m.done()


# ---------------------------------------------------------------------------
# MobileNetV3 (torchvision naming: features.N.block.J)
# ---------------------------------------------------------------------------

def convert_mobilenet_v3(state_dict, arch="large"):
    """torchvision MobileNetV3 -> zoo MobileNetV3. Block sub-layout is
    [expand?][dw][se?][project]; SE fc1/fc2 are 1x1 convs -> Dense. The
    trailing `features.{16|12}` 6x conv (classifier neck) has no zoo
    counterpart and is skipped."""
    from .models.zoo.backbones import MNV3_LARGE, MNV3_SMALL
    table = MNV3_LARGE if arch == "large" else MNV3_SMALL
    m = _Mapper(state_dict)
    m.conv(["stem"], "features.0.0.weight")
    m.bn(["stem_bn"], "features.0.1")
    in_ch = 16
    for i, (k, e, o, se, act, s) in enumerate(table):
        p, dst = f"features.{i + 1}.block", [f"block{i}"]
        j = 0
        if e != in_ch:
            m.conv(dst + ["expand"], f"{p}.{j}.0.weight")
            m.bn(dst + ["expand_bn"], f"{p}.{j}.1")
            j += 1
        m.conv(dst + ["dw"], f"{p}.{j}.0.weight")
        m.bn(dst + ["dw_bn"], f"{p}.{j}.1")
        j += 1
        if se:
            m.dense(dst + ["se", "fc1"], f"{p}.{j}.fc1")
            m.dense(dst + ["se", "fc2"], f"{p}.{j}.fc2")
            j += 1
        m.conv(dst + ["project"], f"{p}.{j}.0.weight")
        m.bn(dst + ["project_bn"], f"{p}.{j}.1")
        in_ch = o
    return m.done()


# ---------------------------------------------------------------------------
# MiT (SegFormer official naming: patch_embedN / blockN.J / normN)
# ---------------------------------------------------------------------------

def convert_mit(state_dict, variant="mit_b0"):
    """SegFormer-official MixVisionTransformer -> models.segformer
    MixTransformer. All-LayerNorm, no batch stats."""
    dims, depths, heads, srs, _ = VARIANTS[variant]
    m = _Mapper(state_dict)
    for i in range(4):
        pe = f"patch_embed{i + 1}"
        m.conv([pe, "Conv_0"], pe + ".proj.weight", bias=True)
        m.ln([pe, "norm"], pe + ".norm")
        for j in range(depths[i]):
            p, dst = f"block{i + 1}.{j}", [f"block{i + 1}_{j}"]
            m.ln(dst + ["norm1"], p + ".norm1")
            m.dense(dst + ["attn", "q"], p + ".attn.q")
            m.dense(dst + ["attn", "kv"], p + ".attn.kv")
            m.dense(dst + ["attn", "proj"], p + ".attn.proj")
            if srs[i] > 1:
                m.conv(dst + ["attn", "sr"], p + ".attn.sr.weight",
                       bias=True)
                m.ln(dst + ["attn", "sr_norm"], p + ".attn.norm")
            m.ln(dst + ["norm2"], p + ".norm2")
            m.dense(dst + ["ffn", "fc1"], p + ".mlp.fc1")
            m.conv(dst + ["ffn", "dwconv"], p + ".mlp.dwconv.dwconv.weight",
                   bias=True)
            m.dense(dst + ["ffn", "fc2"], p + ".mlp.fc2")
        m.ln([f"norm{i + 1}"], f"norm{i + 1}")
    return m.done()


# ---------------------------------------------------------------------------
# UNet (mmseg naming: encoder.i.j.convs.k / decoder.i)
# ---------------------------------------------------------------------------

def convert_unet(sd, num_stages=5):
    """mmseg UNet (`backbones/unet.py:222-408`, mmcv naming) ->
    ``zoo.backbones.UNetBackbone``.

    Torch layout: ``encoder.{i}.{0|1}.convs.{k}.{conv,bn}`` (BasicConvBlock
    sits at Sequential index 1 when preceded by MaxPool),
    ``decoder.{i}.conv_block.convs.{k}``, and the upsampler is either
    ``decoder.{i}.upsample.interp_upsample.1.{conv,bn}`` (InterpConv:
    Sequential(upsample, ConvModule)) or
    ``decoder.{i}.upsample.deconv_upsamping.{0,1}`` (DeconvModule).
    torch ConvTranspose2d weights are (in, out, kh, kw) acting as the
    *gradient* of a conv; flax ConvTranspose applies the kernel unflipped,
    so the spatial dims are reversed on top of the axis permute."""
    m = _Mapper(sd)
    for i in range(num_stages):
        blk = None
        for j in (0, 1):
            if f"encoder.{i}.{j}.convs.0.conv.weight" in sd:
                blk = f"encoder.{i}.{j}"
                break
        assert blk is not None, f"no BasicConvBlock for encoder stage {i}"
        k = 0
        while f"{blk}.convs.{k}.conv.weight" in sd:
            m.conv([f"enc{i}", f"conv{k}", "conv"],
                   f"{blk}.convs.{k}.conv.weight")
            m.bn([f"enc{i}", f"conv{k}", "bn"], f"{blk}.convs.{k}.bn")
            k += 1
    for i in range(num_stages - 1):
        up = f"decoder.{i}.upsample"
        if f"{up}.interp_upsample.1.conv.weight" in sd:
            m.conv([f"dec{i}", "upsample", "conv", "conv"],
                   f"{up}.interp_upsample.1.conv.weight")
            m.bn([f"dec{i}", "upsample", "conv", "bn"],
                 f"{up}.interp_upsample.1.bn")
        elif f"{up}.interp_upsample.0.conv.weight" in sd:  # conv_first
            m.conv([f"dec{i}", "upsample", "conv", "conv"],
                   f"{up}.interp_upsample.0.conv.weight")
            m.bn([f"dec{i}", "upsample", "conv", "bn"],
                 f"{up}.interp_upsample.0.bn")
        elif f"{up}.deconv_upsamping.0.weight" in sd:
            w = np.asarray(sd[f"{up}.deconv_upsamping.0.weight"])
            _put(m.params, [f"dec{i}", "upsample", "deconv", "kernel"],
                 w[:, :, ::-1, ::-1].transpose(2, 3, 0, 1))
            if f"{up}.deconv_upsamping.0.bias" in sd:
                _put(m.params, [f"dec{i}", "upsample", "deconv", "bias"],
                     sd[f"{up}.deconv_upsamping.0.bias"])
            m.bn([f"dec{i}", "upsample", "bn"], f"{up}.deconv_upsamping.1")
        elif f"{up}.conv.weight" in sd:  # identity-resolution 1x1 ConvModule
            m.conv([f"dec{i}", "upsample", "conv"], f"{up}.conv.weight")
            m.bn([f"dec{i}", "upsample", "bn"], f"{up}.bn")
        else:
            raise KeyError(f"unrecognized upsampler under {up}")
        k = 0
        blk = f"decoder.{i}.conv_block"
        while f"{blk}.convs.{k}.conv.weight" in sd:
            m.conv([f"dec{i}", "conv_block", f"conv{k}", "conv"],
                   f"{blk}.convs.{k}.conv.weight")
            m.bn([f"dec{i}", "conv_block", f"conv{k}", "bn"],
                 f"{blk}.convs.{k}.bn")
            k += 1
    return m.done()


# ---------------------------------------------------------------------------
# Full mmseg segmentor checkpoints (backbone + decode head -> the exact
# variables tree `zoo.builder.build_segmentor` initializes). Decode-head
# key layouts follow `models/mmseg/models/decode_heads/*.py`; auxiliary
# heads are train-time deep supervision only and are dropped for
# inference conversion (reported to the caller).
# ---------------------------------------------------------------------------

def _cm(m, dst, src):
    """mmcv ConvModule `src.{conv,bn}` -> zoo ConvModule `dst/{conv,bn}`."""
    m.conv(dst + ["conv"], src + ".conv.weight")
    m.bn(dst + ["bn"], src + ".bn")


def _dscm(m, dst, src):
    """mmcv DepthwiseSeparableConvModule -> zoo DS module naming."""
    m.conv(dst + ["depthwise"], src + ".depthwise_conv.conv.weight")
    m.bn(dst + ["dw_bn"], src + ".depthwise_conv.bn")
    m.conv(dst + ["pointwise"], src + ".pointwise_conv.conv.weight")
    m.bn(dst + ["pw_bn"], src + ".pointwise_conv.bn")


def _cls(m):
    """BaseDecodeHead classifier `conv_seg` (with bias) -> cls/conv_seg."""
    m.conv(["cls", "conv_seg"], "conv_seg.weight", bias=True)


def _count(sd, fmt):
    n = 0
    while fmt.format(n) in sd:
        n += 1
    return n


def convert_fcn_head(sd):
    """`fcn_head.py`: convs.{i} (+ conv_cat when concat_input)."""
    m = _Mapper(sd)
    for i in range(_count(sd, "convs.{}.conv.weight")):
        _cm(m, [f"convs_{i}"], f"convs.{i}")
    if "conv_cat.conv.weight" in sd:
        _cm(m, ["conv_cat"], "conv_cat")
    _cls(m)
    return m.done()


def convert_psp_head(sd):
    """`psp_head.py`: psp_modules.{i}.1 (index 0 = AdaptiveAvgPool)."""
    m = _Mapper(sd)
    for i in range(_count(sd, "psp_modules.{}.1.conv.weight")):
        _cm(m, ["ppm", f"pool_{i}"], f"psp_modules.{i}.1")
    _cm(m, ["bottleneck"], "bottleneck")
    _cls(m)
    return m.done()


def convert_aspp_head(sd):
    """`aspp_head.py` + `sep_aspp_head.py`: image_pool.1, aspp_modules
    (plain ConvModule or DepthwiseSeparable, auto-detected per branch),
    bottleneck, optional c1_bottleneck/sep_bottleneck (deeplabv3plus)."""
    m = _Mapper(sd)
    _cm(m, ["image_pool"], "image_pool.1")
    i = 0
    while True:
        if f"aspp_modules.{i}.conv.weight" in sd:
            _cm(m, ["aspp", f"branch_{i}"], f"aspp_modules.{i}")
        elif f"aspp_modules.{i}.depthwise_conv.conv.weight" in sd:
            _dscm(m, ["aspp", f"branch_{i}"], f"aspp_modules.{i}")
        else:
            break
        i += 1
    _cm(m, ["bottleneck"], "bottleneck")
    if "c1_bottleneck.conv.weight" in sd:
        _cm(m, ["c1_bottleneck"], "c1_bottleneck")
    j = 0
    while f"sep_bottleneck.{j}.depthwise_conv.conv.weight" in sd:
        _dscm(m, [f"sep_bottleneck_{j}"], f"sep_bottleneck.{j}")
        j += 1
    _cls(m)
    return m.done()


def convert_uper_head(sd):
    """`uper_head.py`: PPM + (psp) bottleneck + lateral/fpn convs +
    fpn_bottleneck."""
    m = _Mapper(sd)
    for i in range(_count(sd, "psp_modules.{}.1.conv.weight")):
        _cm(m, ["ppm", f"pool_{i}"], f"psp_modules.{i}.1")
    _cm(m, ["psp_bottleneck"], "bottleneck")
    for i in range(_count(sd, "lateral_convs.{}.conv.weight")):
        _cm(m, [f"lateral_{i}"], f"lateral_convs.{i}")
    for i in range(_count(sd, "fpn_convs.{}.conv.weight")):
        _cm(m, [f"fpn_conv_{i}"], f"fpn_convs.{i}")
    _cm(m, ["fpn_bottleneck"], "fpn_bottleneck")
    _cls(m)
    return m.done()


def convert_ocr_head(sd):
    """`ocr_head.py`: bottleneck + ObjectAttentionBlock (2-conv key/query
    projections, 1-conv value/out, its own 1x1 bottleneck)."""
    m = _Mapper(sd)
    _cm(m, ["bottleneck"], "bottleneck")
    ocb = "object_context_block"
    _cm(m, ["oab_bottleneck"], f"{ocb}.bottleneck")
    for proj, n in (("key_project", 2), ("query_project", 2),
                    ("value_project", 1), ("out_project", 1)):
        for i in range(n):
            _cm(m, ["object_attention", f"{proj}_{i}"], f"{ocb}.{proj}.{i}")
    _cls(m)
    return m.done()


HEAD_CONVERTERS = {
    "fcn": convert_fcn_head,
    "pspnet": convert_psp_head,
    "deeplabv3": convert_aspp_head,
    "deeplabv3plus": convert_aspp_head,
    "upernet": convert_uper_head,
}

# zoo builder backbone name -> backbone state-dict converter
ZOO_BACKBONES = {
    "resnet50_v1c": lambda sd: convert_resnet(sd, 50),
    "resnet101_v1c": lambda sd: convert_resnet(sd, 101),
    "resnext50": lambda sd: convert_resnet(sd, 50, "resnext"),
    "resnext101": lambda sd: convert_resnet(sd, 101, "resnext"),
    "resnest50": lambda sd: convert_resnet(sd, 50, "resnest"),
    "resnest101": lambda sd: convert_resnet(sd, 101, "resnest"),
    "hrnet_w18": convert_hrnet,
    "hrnet_w32": convert_hrnet,
    "hrnet_w48": convert_hrnet,
    "mobilenet_v3_large": lambda sd: convert_mobilenet_v3(sd, "large"),
    "mobilenet_v3_small": lambda sd: convert_mobilenet_v3(sd, "small"),
    "unet_s5_d16": convert_unet,
}


def _subdict(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items()
            if k.startswith(prefix)}


def convert_segformer_head(sd):
    """`segformer_head.py:35-87`: per-stage MLP projections
    (``linear_c{i}.proj``), BN'd 1x1 fuse, classifier — mapped onto
    `models.segformer.SegFormerHead` naming."""
    m = _Mapper(sd)
    i = 1
    while f"linear_c{i}.proj.weight" in sd:
        m.dense([f"linear_c{i}"], f"linear_c{i}.proj")
        i += 1
    m.conv(["linear_fuse"], "linear_fuse.conv.weight")
    m.bn(["BatchNorm_0"], "linear_fuse.bn")
    m.conv(["linear_pred"], "linear_pred.weight", bias=True)
    return m.done()


def convert_segformer(state_dict, variant="mit_b1"):
    """Official SegFormer release checkpoint (MiT backbone + all-MLP
    head) -> `models.segformer.SegFormer` variables; returns
    ``(variables, dropped)`` like :func:`convert_segmentor`."""
    bp, bs = convert_mit(_subdict(state_dict, "backbone."), variant)
    hp, hs = convert_segformer_head(_subdict(state_dict, "decode_head."))
    dropped = sorted({k.split(".")[0] for k in state_dict
                      if not k.startswith(("backbone.", "decode_head."))})
    return {"params": {"backbone": bp, "head": hp},
            "batch_stats": {"backbone": bs, "head": hs}}, dropped


def convert_segmentor(state_dict, arch, backbone):
    """mmseg checkpoint -> ``{"params", "batch_stats"}`` loadable into
    ``build_segmentor(arch, backbone, num_classes)`` variables.

    Returns ``(variables, dropped)`` where dropped lists top-level torch
    prefixes not carried over (auxiliary heads; anything unrecognized)."""
    bb_sd = _subdict(state_dict, "backbone.")
    head_sd = _subdict(state_dict, "decode_head.")
    bp, bs = ZOO_BACKBONES[backbone](bb_sd)
    params, stats = {"backbone": bp}, {"backbone": bs}
    if arch == "ocrnet":
        # CascadeEncoderDecoder: decode_head is a ModuleList — .0 is the
        # FCN stage, .1 the OCR refiner (`cascade_encoder_decoder.py`)
        hp, hs = convert_fcn_head(_subdict(head_sd, "0."))
        params["decode_head"], stats["decode_head"] = hp, hs
        op, os_ = convert_ocr_head(_subdict(head_sd, "1."))
        params["cascade_heads_0"], stats["cascade_heads_0"] = op, os_
    else:
        hp, hs = HEAD_CONVERTERS[arch](head_sd)
        params["decode_head"], stats["decode_head"] = hp, hs
    dropped = sorted({k.split(".")[0] for k in state_dict
                      if not k.startswith(("backbone.", "decode_head."))})
    return {"params": params, "batch_stats": stats}, dropped


ARCHS = {
    "mobilenet_v2": lambda sd: convert(sd),
    "resnet50": lambda sd: convert_resnet(sd, 50),
    "resnet101": lambda sd: convert_resnet(sd, 101),
    "resnet152": lambda sd: convert_resnet(sd, 152),
    "resnext50": lambda sd: convert_resnet(sd, 50, "resnext"),
    "resnext101": lambda sd: convert_resnet(sd, 101, "resnext"),
    "resnest50": lambda sd: convert_resnet(sd, 50, "resnest"),
    "resnest101": lambda sd: convert_resnet(sd, 101, "resnest"),
    "hrnet18": lambda sd: convert_hrnet(sd),
    "hrnet32": lambda sd: convert_hrnet(sd),
    "hrnet48": lambda sd: convert_hrnet(sd),
    "mobilenet_v3_large": lambda sd: convert_mobilenet_v3(sd, "large"),
    "mobilenet_v3_small": lambda sd: convert_mobilenet_v3(sd, "small"),
    "mit_b0": lambda sd: convert_mit(sd, "mit_b0"),
    "mit_b1": lambda sd: convert_mit(sd, "mit_b1"),
    "mit_b2": lambda sd: convert_mit(sd, "mit_b2"),
    "mit_b3": lambda sd: convert_mit(sd, "mit_b3"),
    "mit_b4": lambda sd: convert_mit(sd, "mit_b4"),
    "mit_b5": lambda sd: convert_mit(sd, "mit_b5"),
    "unet_s5_d16": lambda sd: convert_unet(sd),
}


def convert_file(src: str, dst: str, arch: str = "mobilenet_v2",
                 segmentor=None, backbone=None) -> list:
    """Convert the torch checkpoint ``src`` (loaded with
    ``weights_only=True``; a module's ``.state_dict()``, the open-mmlab
    ``state_dict`` and official ``model`` wrappers unwrapped) and
    ``torch.save`` the port's state_dict entries to ``dst``: the backbone
    map ``arch`` (a leading ``backbone.`` stripped from the source keys),
    or with ``segmentor`` the whole segmentor over ``backbone``. Returns
    the dropped top-level source prefixes of a whole segmentor."""
    ckpt = torch.load(src, map_location="cpu", weights_only=True)
    if hasattr(ckpt, "state_dict"):
        ckpt = ckpt.state_dict()
    for key in ("state_dict", "model"):  # open-mmlab / official wrappers
        if isinstance(ckpt, dict) and key in ckpt:
            ckpt = ckpt[key]
    dropped = []
    if segmentor:
        if not backbone:
            raise ValueError("--segmentor requires --backbone")
        if segmentor == "segformer":
            variables, dropped = convert_segformer(ckpt, backbone)
        else:
            variables, dropped = convert_segmentor(ckpt, segmentor,
                                                   backbone)
    else:
        ckpt = {k[len("backbone."):] if k.startswith("backbone.") else k: v
                for k, v in ckpt.items()}
        params, stats = ARCHS[arch](ckpt)
        variables = {"params": params, "batch_stats": stats}
    torch.save(from_flax(variables), dst)
    return dropped


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m aadg_tpu_torch.convert_weights")
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--arch", default="mobilenet_v2", choices=sorted(ARCHS))
    ap.add_argument("--segmentor", choices=sorted(HEAD_CONVERTERS)
                    + ["ocrnet", "segformer"], default=None,
                    help="convert a FULL mmseg segmentor checkpoint "
                         "(backbone + decode head) for this arch; "
                         "--backbone selects the zoo backbone name")
    ap.add_argument("--backbone", choices=sorted(ZOO_BACKBONES)
                    + sorted(VARIANTS), default=None,
                    help="zoo backbone (with --segmentor)")
    args = ap.parse_args(argv)
    try:
        dropped = convert_file(args.src, args.dst, args.arch,
                               args.segmentor, args.backbone)
    except pickle.UnpicklingError as e:
        print(f"{args.src} needs a full unpickle, which this tool does not "
              f"do (torch.load(weights_only=True) refused it: "
              f"{str(e).splitlines()[0]})", file=sys.stderr)
        return 1
    if dropped:
        print(f"dropped (train-time-only / unknown): {dropped}")
    what = (f"{args.segmentor}/{args.backbone}" if args.segmentor
            else args.arch)
    print(f"wrote {args.dst} ({what})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
