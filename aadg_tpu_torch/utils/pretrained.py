"""Load converted pretrained weights into a built model (port of
``aadg_tpu/utils/pretrained.py``).

The reference starts from ImageNet encoders; here the weights arrive as a
``torch.save``d dict of the port's state_dict keys written by
``python -m aadg_tpu_torch.convert_weights``, relative to the module they
belong in, and are copied into the freshly built model (config key
``TPU.PRETRAINED``, optionally ``path::sub/module`` to name that module).

Otherwise the graft point is found: the unique submodule whose children
and own parameters and buffers include every top-level name of the file
(``encoder`` for DeepLabV3+/MobileNetV2, ``backbone`` for the zoo's
segmentors and SegFormer, the root for a whole segmentor). Every tensor's
shape is checked, BatchNorm running statistics load with the parameters,
and a name or shape the model lacks fails loudly instead of training from
a silent partial load.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn


def _names(module: nn.Module) -> set:
    return ({n for n, _ in module.named_children()}
            | {n for n, _ in module.named_parameters(recurse=False)}
            | {n for n, _ in module.named_buffers(recurse=False)})


def find_graft_point(model: nn.Module, loaded: Dict[str, torch.Tensor],
                     prefix: Optional[str] = None) -> List[str]:
    """The path (module names) of the module ``loaded`` belongs in:
    ``prefix`` split at '/', else the unique module whose names hold every
    top-level name of ``loaded``."""
    if prefix is not None:
        return [p for p in prefix.split("/") if p]
    want = {k.split(".", 1)[0] for k in loaded}
    matches: List[List[str]] = []

    def walk(module, path):
        if want <= _names(module):
            matches.append(path)
            return
        for name, child in module.named_children():
            walk(child, path + [name])

    walk(model, [])
    if len(matches) != 1:
        raise ValueError(
            f"pretrained graft point {'ambiguous' if matches else 'not found'}"
            f" for checkpoint keys {sorted(want)[:4]}...: matches={matches}")
    return matches[0]


def load_pretrained(model: nn.Module, path: str, logger=None) -> List[str]:
    """Copy the weights in ``path`` (``file.pt`` or ``file.pt::sub/module``)
    into ``model`` in place; returns the graft point's path."""
    prefix = None
    if "::" in path:
        path, prefix = path.split("::", 1)
    loaded = torch.load(path, map_location="cpu", weights_only=True)
    at = find_graft_point(model, loaded, prefix)
    where = "/".join(at) or "<root>"
    target = model.get_submodule(".".join(at)).state_dict()
    for key, value in loaded.items():
        if key not in target:
            raise KeyError(f"{where}/{key}: missing in the model")
        if tuple(value.shape) != tuple(target[key].shape):
            raise ValueError(f"{where}/{key}: shape {tuple(value.shape)} != "
                             f"model {tuple(target[key].shape)}")
    with torch.no_grad():
        for key, value in loaded.items():
            target[key].copy_(value)
    if logger is not None:
        logger.info(f"loaded pretrained weights {path} at {where} "
                    f"({len(loaded)} tensors)")
    return at
