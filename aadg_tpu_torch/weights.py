"""Convert the JAX package's parameters (as numpy arrays) to state_dicts.

The port's modules carry the flax module names, so a flax path maps to a
state_dict key by joining with dots and renaming the leaf: ``kernel`` ->
``weight`` (conv HWIO -> OIHW, which also takes a grouped (kh, kw, in/g,
out) kernel to (out, in/g, kh, kw) and a depthwise (kh, kw, 1, C) to
(C, 1, kh, kw); a flax ConvTranspose kernel (kh, kw, in, out) lands as
(out, in, kh, kw), the layout ``models/zoo/backbones.py::DeconvModule``
keeps; Dense (in, out) -> (out, in)), ``scale`` -> ``weight``,
``bias`` -> ``bias``, and the batch statistics ``mean``/``var`` ->
``running_mean``/``running_var``. The zoo's own leaves keep their names:
the attention scales ``gamma``, ``pam_gamma``, ``cam_gamma``, EncHead's
``codewords`` and its codeword ``scale`` (told from a norm's by its
sibling ``codewords``), EMAHead's running ``bases``, and CGNet's
per-channel PReLU slopes ``alpha``. Applies to the
segmentation model and the discriminator; the controller's plain
parameter dict has its own map.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var",
         **{k: k for k in ("gamma", "pam_gamma", "cam_gamma", "codewords",
                           "bases", "alpha")}}


def leaf_name(name: str, siblings) -> str:
    """The state_dict name of flax leaf ``name`` beside ``siblings`` (the
    names in its module's collection)."""
    if name == "scale" and "codewords" in siblings:
        return "scale"
    return _LEAF[name]


def _walk(tree: Mapping[str, Any], prefix: str, out: Dict[str, torch.Tensor]):
    for name, value in tree.items():
        if isinstance(value, Mapping):
            _walk(value, f"{prefix}{name}.", out)
            continue
        arr = np.asarray(value, dtype=np.float32)
        if name == "kernel":
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        # (ascontiguousarray makes a 0-d array 1-d; the scalars stay 0-d)
        out[prefix + leaf_name(name, tree)] = torch.from_numpy(
            np.ascontiguousarray(arr).reshape(arr.shape))


def from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """state_dict entries for flax ``variables``: {"params": ...} and
    optionally {"batch_stats": ...}, leaves as numpy arrays."""
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        _walk(variables.get(collection, {}), "", out)
    return out


def controller_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """state_dict of ``models.controller.Controller`` for the JAX
    controller's parameter dict (``aadg_tpu/models/controller.py:51``)."""
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))
    lstm = params["lstm"]
    return {"embedding": t(params["embedding"]),
            "lstm.weight_ih": t(lstm["w_ih"]), "lstm.weight_hh": t(lstm["w_hh"]),
            "lstm.bias_ih": t(lstm["b_ih"]), "lstm.bias_hh": t(lstm["b_hh"]),
            "outop.weight": t(params["outop"]["w"]),
            "outop.bias": t(params["outop"]["b"]),
            "outmag.weight": t(params["outmag"]["w"]),
            "outmag.bias": t(params["outmag"]["b"])}
