"""The port's weight converter (``aadg_tpu_torch/convert_weights.py``) and
loader (``aadg_tpu_torch/utils/pretrained.py``, ``TPU.PRETRAINED``)
against the JAX package's ``tools/convert_torch_weights.py`` and
``aadg_tpu/utils/pretrained.py::load_pretrained``, bit for bit.

For each family the JAX tool maps, a seeded state_dict in the source's
naming (the torch oracles of ``test_torch_parity_zoo.py``,
``test_torch_parity.py`` and the head oracles of
``test_torch_parity_heads{,2}.py``, renamed to mmseg's keys as
``test_convert_segmentor.py`` renames them) goes two ways into a model
whose other weights are numpy draws from a seed
(``test_torch_port_zoo.numpy_variables``, the same on both sides):

- the JAX tool's map, ``flax.serialization.to_bytes``, JAX's
  ``load_pretrained`` into the flax tree, then ``weights.from_flax``;
- the port's CLI (``convert_weights.main`` on a ``torch.save``d file),
  then the port's ``load_pretrained`` into the port's model.

Every entry of the two state_dicts is ``torch.equal``, and the graft point
is the same. Families: torchvision MobileNetV2 into DeepLabV3+
(``encoder``); mmcv ResNetV1c-50, ResNeXt-50 and ResNeSt-50 into the FCN
over them, HRNet-W18 into OCRNet, torchvision MobileNetV3 small and large
into LR-ASPP, mmseg's UNet-S5-D16 into the FCN over it (``backbone``);
official MiT-b0 into SegFormer (``backbone``); whole mmseg checkpoints of
PSPNet/ResNetV1c-50 and OCRNet/HRNet-W18 and the official SegFormer-b0
(the root; JAX's loader takes the last only with its empty subtrees
pruned, see ``_pruned``). Then the errors: an explicit ``path::module``,
an ambiguous or missing graft point, a shape that differs (naming the
key), a source key that is missing (naming the torch key), and a
checkpoint that only a full unpickle could read. Last, ``init_state``
draws the same seeded weights with and without a file.
"""

import re

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from aadg_tpu.models.deeplab import DeepLabV3Plus as JDeepLab
from aadg_tpu.models.segformer import SegFormer as JSegFormer
from aadg_tpu.models.zoo import builder as jbuilder
from aadg_tpu.models.zoo.backbones import _MNV3_LARGE, _MNV3_SMALL
from aadg_tpu.utils.pretrained import load_pretrained as jload
from aadg_tpu_torch import convert_weights as tconv
from aadg_tpu_torch.config import load_config
from aadg_tpu_torch.engine import state as tstate
from aadg_tpu_torch.models.deeplab import DeepLabV3Plus as TDeepLab
from aadg_tpu_torch.models.segformer import SegFormer as TSegFormer
from aadg_tpu_torch.models.zoo import builder as tbuilder
from aadg_tpu_torch.utils.pretrained import load_pretrained as tload
from aadg_tpu_torch.weights import from_flax
from test_torch_parity import _torch_mobilenet_v2
from test_torch_parity_heads import TOCRHead
from test_torch_parity_heads2 import TFCN, TPSP, TSegFormerHead, _randomize
from test_torch_parity_zoo import (TConvBNAct, THRNet, TInvertedResidualV3,
                                   TMit, TResNet, TUNet, _randomize_bn)
from test_torch_port_zoo import numpy_variables
from tools import convert_torch_weights as jconv
from torch_port_helpers import few_torch_threads  # noqa: F401

CROP = np.zeros((1, 64, 64, 3), np.float32)


def _sd(module, seed):
    """A seeded state_dict of ``module`` (random BatchNorm statistics)."""
    torch.manual_seed(seed)
    for m in module.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            m.weight.data.normal_(0, 0.1)
    _randomize_bn(module)
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _mnv3(table):
    mods = [TConvBNAct(3, 16, 3, 2, act=torch.nn.Hardswish)]
    cin = 16
    for (k, e, o, se, act, s) in table:
        mods.append(TInvertedResidualV3(cin, k, e, o, se, act, s))
        cin = o
    return {f"features.{k}": v
            for k, v in _sd(torch.nn.Sequential(*mods), 3).items()}


def _rename(sd, rules):
    out = {}
    for k, v in sd.items():
        for pat, repl in rules:
            k2, n = re.subn(pat, repl, k)
            if n:
                k = k2
                break
        out[k] = v
    return out


def _pspnet_r50():
    sd = {f"backbone.{k}": v for k, v in _sd(TResNet(), 5).items()}
    head = TPSP(2048, 512, 2)
    _randomize(head, 9)
    sd.update(_rename({f"decode_head.{k}": v
                       for k, v in head.state_dict().items()},
                      [(r"^decode_head\.pools\.(\d+)\.",
                        r"decode_head.psp_modules.\1.1.")]))
    sd["auxiliary_head.convs.0.conv.weight"] = torch.zeros(2, 2, 1, 1)
    return sd


def _ocrnet_hr18():
    sd = {f"backbone.{k}": v for k, v in _sd(THRNet(18), 6).items()}
    fcn = TFCN(270, 512, 2, num_convs=1)
    ocr = TOCRHead(270, 512, 256, 2)
    _randomize(fcn, 10)
    _randomize(ocr, 11)
    sd.update({f"decode_head.0.{k}": v for k, v in fcn.state_dict().items()
               if not k.startswith("conv_cat.")})
    sd.update(_rename(
        {f"decode_head.1.{k}": v for k, v in ocr.state_dict().items()},
        [(r"^decode_head\.1\.(key|query)_project\.(\d+)\.",
          r"decode_head.1.object_context_block.\1_project.\2."),
         (r"^decode_head\.1\.value_project\.",
          "decode_head.1.object_context_block.value_project.0."),
         (r"^decode_head\.1\.out_project\.",
          "decode_head.1.object_context_block.out_project.0."),
         (r"^decode_head\.1\.oab_bottleneck\.",
          "decode_head.1.object_context_block.bottleneck.")]))
    return sd


def _segformer_b0():
    sd = {f"backbone.{k}": v for k, v in _sd(TMit(), 7).items()}
    head = TSegFormerHead((32, 64, 160, 256), 256, 2)
    _randomize(head, 12)
    sd.update(_rename(
        {f"decode_head.{k}": v for k, v in head.state_dict().items()},
        [(r"^decode_head\.linears\.(\d+)\.", lambda mo:
          f"decode_head.linear_c{int(mo.group(1)) + 1}.proj."),
         (r"^decode_head\.fuse\.", "decode_head.linear_fuse."),
         (r"^decode_head\.pred\.", "decode_head.linear_pred.")]))
    return sd


def _zoo(arch, backbone):
    return (lambda: jbuilder.build_segmentor(arch, backbone, 2)[0],
            lambda: tbuilder.build_segmentor(arch, backbone, 2)[0])


# name: (source state_dict, converter flags, (JAX model, port model),
#        graft point)
CASES = {
    "mobilenet_v2": (lambda: {f"features.{k}": v for k, v in _sd(
        _torch_mobilenet_v2(), 1).items()}, ["--arch", "mobilenet_v2"],
        (lambda: JDeepLab(num_classes=2), lambda: TDeepLab(2)),
        ["encoder"]),
    "resnet50": (lambda: _sd(TResNet(), 2), ["--arch", "resnet50"],
                 _zoo("fcn", "resnet50_v1c"), ["backbone"]),
    "resnext50": (lambda: _sd(TResNet(groups=32, base_width=4), 2),
                  ["--arch", "resnext50"], _zoo("fcn", "resnext50"),
                  ["backbone"]),
    "resnest50": (lambda: _sd(TResNet(family="resnest"), 2),
                  ["--arch", "resnest50"], _zoo("fcn", "resnest50"),
                  ["backbone"]),
    "hrnet18": (lambda: _sd(THRNet(18), 2), ["--arch", "hrnet18"],
                _zoo("ocrnet", "hrnet_w18"), ["backbone"]),
    "mobilenet_v3_small": (lambda: _mnv3(_MNV3_SMALL),
                           ["--arch", "mobilenet_v3_small"],
                           _zoo("lraspp", "mobilenet_v3_small"),
                           ["backbone"]),
    "mobilenet_v3_large": (lambda: _mnv3(_MNV3_LARGE),
                           ["--arch", "mobilenet_v3_large"],
                           _zoo("lraspp", "mobilenet_v3_large"),
                           ["backbone"]),
    "mit_b0": (lambda: _sd(TMit(), 4), ["--arch", "mit_b0"],
               (lambda: JSegFormer(num_classes=2, variant="mit_b0"),
                lambda: TSegFormer(2, "mit_b0")), ["backbone"]),
    "unet_s5_d16": (lambda: _sd(TUNet(base=64, num_stages=5), 2),
                    ["--arch", "unet_s5_d16"], _zoo("fcn", "unet_s5_d16"),
                    ["backbone"]),
    "pspnet_r50": (_pspnet_r50, ["--segmentor", "pspnet", "--backbone",
                                 "resnet50_v1c"],
                   _zoo("pspnet", "resnet50_v1c"), []),
    "ocrnet_hr18": (_ocrnet_hr18, ["--segmentor", "ocrnet", "--backbone",
                                   "hrnet_w18"],
                    _zoo("ocrnet", "hrnet_w18"), []),
    "segformer_b0": (_segformer_b0, ["--segmentor", "segformer",
                                     "--backbone", "mit_b0"],
                     (lambda: JSegFormer(num_classes=2, variant="mit_b0"),
                      lambda: TSegFormer(2, "mit_b0")), []),
}


def _jax_tool(sd, flags):
    """The JAX tool's tree for ``sd`` under the CLI's ``flags``."""
    sd = {k: v.numpy() for k, v in sd.items()}
    if flags[0] == "--arch":
        sd = {k[len("backbone."):] if k.startswith("backbone.") else k: v
              for k, v in sd.items()}
        params, stats = jconv.ARCHS[flags[1]](sd)
        return {"params": params, "batch_stats": stats}
    if flags[1] == "segformer":
        return jconv.convert_segformer(sd, flags[3])[0]
    return jconv.convert_segmentor(sd, flags[1], flags[3])[0]


def _pruned(tree):
    """``tree`` without empty subtrees. JAX's ``load_pretrained`` refuses
    the whole official SegFormer's converted tree as the JAX tool writes
    it: its ``batch_stats`` hold an empty ``backbone`` (MiT has no
    BatchNorm), which the model's statistics lack (KeyError
    'batch_stats/backbone: missing in target tree'). The port's flat file
    has no entry for an empty subtree."""
    if not isinstance(tree, dict):
        return tree
    return {k: _pruned(v) for k, v in tree.items()
            if not (isinstance(v, dict) and not _pruned(v))}


def _port_model(make, init):
    """The port's model built on the meta device, holding ``init``."""
    with torch.device("meta"):
        model = make()
    model.load_state_dict(from_flax(init), strict=True, assign=True)
    return model


def _convert(tmp_path, name, sd):
    src, dst = tmp_path / f"{name}.pth", tmp_path / f"{name}.pt"
    torch.save(sd, src)
    flags = CASES[name][1]
    assert tconv.main([*flags, str(src), str(dst)]) == 0
    return dst


@pytest.mark.parametrize("name", sorted(CASES))
def test_converter_and_loader_match_jax(tmp_path, name):
    make_sd, flags, (jmake, tmake), at = CASES[name]
    sd = make_sd()
    init = numpy_variables(jmake(), CROP, train=False, seed=1)

    path = tmp_path / f"{name}.msgpack"
    path.write_bytes(serialization.to_bytes(_pruned(_jax_tool(sd, flags))))
    params, stats = jload(init["params"], init.get("batch_stats", {}),
                          str(path))
    want = from_flax(jax.tree_util.tree_map(
        np.array, {"params": params, "batch_stats": stats}))

    model = _port_model(tmake, init)
    assert tload(model, str(_convert(tmp_path, name, sd))) == at
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    # the file's weights landed: its entries differ from the seeded init
    loaded = torch.load(tmp_path / f"{name}.pt", weights_only=True)
    before = from_flax(init)
    prefix = "".join(f"{p}." for p in at)
    assert any(not torch.equal(v, before[prefix + k])
               for k, v in loaded.items())


# -- errors -----------------------------------------------------------------

@pytest.fixture(scope="module")
def lraspp(tmp_path_factory):
    """An LR-ASPP/MobileNetV3-small model and a converted MNv3 file."""
    tmp = tmp_path_factory.mktemp("mnv3")
    sd = _mnv3(_MNV3_SMALL)
    src, dst = tmp / "mnv3.pth", tmp / "mnv3.pt"
    torch.save(sd, src)
    assert tconv.main(["--arch", "mobilenet_v3_small", str(src),
                       str(dst)]) == 0
    return tmp, sd, dst


def _lraspp_model():
    torch.manual_seed(0)
    return tbuilder.build_segmentor("lraspp", "mobilenet_v3_small", 2)[0]


def test_explicit_graft_point(lraspp):
    _, _, dst = lraspp
    auto, named = _lraspp_model(), _lraspp_model()
    assert tload(auto, str(dst)) == ["backbone"]
    assert tload(named, f"{dst}::backbone") == ["backbone"]
    for (k, a), (_, b) in zip(auto.state_dict().items(),
                              named.state_dict().items()):
        assert torch.equal(a, b), k
    with pytest.raises(KeyError, match="decode_head/stem.weight: missing"):
        tload(_lraspp_model(), f"{dst}::decode_head")


@pytest.mark.parametrize("keys,what", [
    (["conv.weight"], "ambiguous"), (["no_such_module.weight"], "not found")])
def test_graft_point_ambiguous_or_missing(tmp_path, keys, what):
    path = tmp_path / "w.pt"
    torch.save({k: torch.zeros(1) for k in keys}, path)
    with pytest.raises(ValueError, match=f"graft point {what}"):
        tload(_lraspp_model(), str(path))
    # JAX's loader says the same of the same names
    tree = {"params": {keys[0].split(".")[0]: {"kernel": np.zeros(1)}}}
    jpath = tmp_path / "w.msgpack"
    jpath.write_bytes(serialization.to_bytes(tree))
    jmodel = jbuilder.build_segmentor("lraspp", "mobilenet_v3_small", 2)[0]
    init = numpy_variables(jmodel, CROP, train=False)
    with pytest.raises(ValueError, match=f"graft point {what}"):
        jload(init["params"], init["batch_stats"], str(jpath))


def test_shape_mismatch_names_the_key(lraspp):
    tmp, _, dst = lraspp
    loaded = torch.load(dst, weights_only=True)
    loaded["block3.dw.weight"] = torch.zeros(7, 1, 5, 5)
    bad = tmp / "bad.pt"
    torch.save(loaded, bad)
    model = _lraspp_model()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match=r"backbone/block3\.dw\.weight: "
                                         r"shape \(7, 1, 5, 5\)"):
        tload(model, str(bad))
    # nothing was copied before the check failed
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_missing_source_key_names_it(tmp_path, lraspp):
    _, sd, _ = lraspp
    sd = dict(sd)
    del sd["features.4.block.2.fc1.weight"]
    src = tmp_path / "cut.pth"
    torch.save(sd, src)
    with pytest.raises(KeyError, match=r"features\.4\.block\.2\.fc1\.weight"):
        tconv.main(["--arch", "mobilenet_v3_small", str(src),
                    str(tmp_path / "cut.pt")])
    with pytest.raises(KeyError, match=r"features\.4\.block\.2\.fc1\.weight"):
        jconv.convert_mobilenet_v3({k: v.numpy() for k, v in sd.items()},
                                   "small")


class _Meta:
    """An object in a checkpoint's ``meta`` that only a full unpickle
    rebuilds."""


def test_cli_unwraps_and_refuses_a_full_unpickle(tmp_path, lraspp, capsys):
    _, sd, dst = lraspp
    wrapped = tmp_path / "wrapped.pth"
    torch.save({"state_dict": {f"backbone.{k}": v for k, v in sd.items()},
                "meta": {"epoch": 3}}, wrapped)
    out = tmp_path / "out.pt"
    assert tconv.main(["--arch", "mobilenet_v3_small", str(wrapped),
                       str(out)]) == 0
    a, b = (torch.load(p, weights_only=True) for p in (out, dst))
    assert sorted(a) == sorted(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    unsafe = tmp_path / "unsafe.pth"
    torch.save({"state_dict": sd, "meta": _Meta()}, unsafe)
    assert tconv.main(["--arch", "mobilenet_v3_small", str(unsafe),
                       str(tmp_path / "never.pt")]) == 1
    assert "needs a full unpickle" in capsys.readouterr().err
    assert not (tmp_path / "never.pt").exists()


def test_whole_segmentor_reports_dropped_heads(tmp_path, capsys):
    src = tmp_path / "psp.pth"
    torch.save(_pspnet_r50(), src)
    assert tconv.main(["--segmentor", "pspnet", "--backbone",
                       "resnet50_v1c", str(src),
                       str(tmp_path / "psp.pt")]) == 0
    assert "dropped (train-time-only / unknown): ['auxiliary_head']" in \
        capsys.readouterr().out


def test_init_state_draws_the_same_with_weights(lraspp):
    """``init_state`` with ``TPU.PRETRAINED`` seeds as without it: the
    head, the discriminator and the controller are the same draws, the
    backbone holds the file."""
    _, _, dst = lraspp
    cfg = load_config("experiments/zoo/lraspp_mnv3_optic.yaml",
                      ["DATASET.NAME", "synthetic_optic", "TPU.CROP_SIZE",
                       "64", "MODEL.BACKBONE", "mobilenet_v3_small"])
    ent = tstate.build_entities(cfg, "search", device="cpu")
    plain, cs_plain = tstate.init_state(ent, 3)
    grafted, cs = tstate.init_state(ent, 3, str(dst))
    loaded = torch.load(dst, weights_only=True)
    for k, v in grafted.model.state_dict().items():
        want = (loaded[k[len("backbone."):]] if k.startswith("backbone.")
                else plain.model.state_dict()[k])
        assert torch.equal(v, want), k
    for a, b in ((grafted.disc, plain.disc),
                 (cs.controller, cs_plain.controller)):
        for (k, v), (_, w) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
            assert torch.equal(v, w), k
