"""Configuration: a yacs-like CfgNode, the default tree, and a YAML reader.

Same schema and semantics as ``aadg_tpu/config.py`` so every experiment
file loads unchanged. PyYAML is not a dependency of the port: the experiment
files use a small subset of YAML (nested block mappings, plain and quoted
scalars, inline lists, comments), which ``parse_yaml`` reads with PyYAML's
scalar resolution rules.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List


class CfgNode(dict):
    """A dict subclass with attribute access and freeze semantics (yacs-like)."""

    _FROZEN = "__frozen__"

    def __init__(self, init_dict: Dict[str, Any] | None = None):
        super().__init__()
        object.__setattr__(self, CfgNode._FROZEN, False)
        if init_dict:
            for k, v in init_dict.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        if self.is_frozen():
            raise AttributeError(
                f"Attempted to set {name} on a frozen CfgNode")
        self[name] = value

    def __setitem__(self, name: str, value: Any) -> None:
        if self.is_frozen():
            raise AttributeError(
                f"Attempted to set {name} on a frozen CfgNode")
        super().__setitem__(name, value)

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, CfgNode._FROZEN)

    def _set_frozen(self, frozen: bool) -> None:
        object.__setattr__(self, CfgNode._FROZEN, frozen)
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_frozen(frozen)

    def freeze(self) -> None:
        self._set_frozen(True)

    def merge_from_file(self, path: str) -> None:
        with open(path) as f:
            loaded = parse_yaml(f.read()) or {}
        _merge_into(CfgNode(loaded), self)

    def merge_from_list(self, opts: List[Any]) -> None:
        if len(opts) % 2 != 0:
            raise ValueError("Override list must be key, value pairs")
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Non-existent config key: {key}")
            node[leaf] = _coerce(value, node[leaf])

    def dump(self) -> str:
        return "\n".join(_dump_lines(self, 0)) + "\n"

    def __str__(self) -> str:
        return self.dump()


def _dump_lines(node: Dict[str, Any], indent: int) -> List[str]:
    lines = []
    for k in sorted(node):
        v = node[k]
        if isinstance(v, dict):
            lines.append(" " * indent + f"{k}:")
            lines.extend(_dump_lines(v, indent + 2))
        else:
            lines.append(" " * indent + f"{k}: {v!r}")
    return lines


def _coerce(value: Any, old: Any) -> Any:
    """Parse a CLI string override to the type of the existing value."""
    if not isinstance(value, str):
        return value
    if isinstance(old, bool):
        return value.lower() in ("1", "true", "yes")
    if isinstance(old, int):
        return int(value)
    if isinstance(old, float):
        return float(value)
    if isinstance(old, (list, tuple)):
        return _parse_value(value)
    return value


def _merge_into(src: Dict[str, Any], dst: CfgNode) -> None:
    for k, v in src.items():
        if k not in dst:
            raise KeyError(f"Non-existent config key: {k}")
        if isinstance(dst[k], CfgNode) and isinstance(v, dict):
            _merge_into(v, dst[k])
        else:
            dst[k] = _coerce(v, dst[k]) if isinstance(v, str) else v


# ---------------------------------------------------------------------------
# YAML subset reader
# ---------------------------------------------------------------------------

# PyYAML's YAML 1.1 implicit resolvers (yaml/resolver.py), minus timestamps
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")


def _parse_scalar(text: str) -> Any:
    s = text.strip()
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        body = s[1:-1]
        return body.replace("''", "'") if s[0] == "'" else body
    if _NULL.match(s):
        return None
    if _BOOL.match(s):
        return s.lower() in ("yes", "true", "on")
    if _INT.match(s):
        t = s.replace("_", "")
        sign = -1 if t.startswith("-") else 1
        t = t.lstrip("+-")
        if t.startswith("0b"):
            return sign * int(t[2:], 2)
        if t.startswith("0x"):
            return sign * int(t[2:], 16)
        if len(t) > 1 and t.startswith("0"):
            return sign * int(t, 8)
        return sign * int(t)
    if _FLOAT.match(s):
        t = s.replace("_", "").lower()
        if t.endswith(".inf"):
            return float("-inf") if t.startswith("-") else float("inf")
        if t.endswith(".nan"):
            return float("nan")
        return float(t)
    return s


def _split_inline(body: str) -> List[str]:
    """Split the inside of a flow sequence at top-level commas."""
    items, depth, quote, cur = [], 0, None, ""
    for ch in body:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        elif ch == "," and depth == 0:
            items.append(cur)
            cur = ""
            continue
        cur += ch
    if cur.strip():
        items.append(cur)
    return items


def _parse_value(text: str) -> Any:
    s = text.strip()
    if s.startswith("["):
        if not s.endswith("]"):
            raise ValueError(f"unterminated inline list: {text!r}")
        return [_parse_value(item) for item in _split_inline(s[1:-1])]
    return _parse_scalar(s)


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def parse_yaml(text: str) -> Dict[str, Any] | None:
    """Read the YAML subset of the experiment files into nested dicts.

    Block mappings nest by indentation; values are plain or quoted scalars
    or inline lists. Anything else (block sequences, anchors, multi-line
    scalars) raises ValueError."""
    root: Dict[str, Any] = {}
    stack = [(-1, root)]  # (indent, mapping)
    pending = None        # (indent, parent, key) of a key with no value yet
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip() or line.strip() in ("---", "..."):
            continue
        indent = len(line) - len(line.lstrip(" "))
        body = line.strip()
        if body.startswith(("- ", "&", "*", "|", ">")) or body == "-":
            raise ValueError(f"line {lineno}: unsupported YAML: {raw!r}")
        key, sep, rest = body.partition(":")
        if not sep or (rest and not rest.startswith(" ")):
            raise ValueError(f"line {lineno}: expected 'key: value': {raw!r}")
        if pending is not None:
            p_indent, p_parent, p_key = pending
            if indent > p_indent:
                child: Dict[str, Any] = {}
                p_parent[p_key] = child
                stack.append((p_indent, child))
            pending = None
        while stack[-1][0] >= indent and len(stack) > 1:
            stack.pop()
        parent = stack[-1][1]
        key = _parse_scalar(key)
        if rest.strip():
            parent[key] = _parse_value(rest)
        else:
            parent[key] = None
            pending = (indent, parent, key)
    return root or None


# ---------------------------------------------------------------------------
# Default configuration tree (aadg_tpu/config.py:138-248, same keys/values)
# ---------------------------------------------------------------------------

def default_config() -> CfgNode:
    _C = CfgNode()

    _C.OUTPUT_DIR = "output"
    _C.LOG_DIR = "log"
    _C.PRINT_FREQ = 100
    _C.SEED = 0

    _C.MODEL = CfgNode()
    _C.MODEL.NAME = "deeplabv3+"
    _C.MODEL.BACKBONE = "mobilenet_v2"
    _C.MODEL.PRETRAINED_WEIGHTS = ""
    _C.MODEL.DROP_PATH_RATE = 0.0

    _C.CONTROLLER = CfgNode()
    _C.CONTROLLER.NAME = "controller"
    _C.CONTROLLER.LOSS = "ppo"
    _C.CONTROLLER.PENALTY = 0.00001
    _C.CONTROLLER.L = 2
    _C.CONTROLLER.M = 6
    _C.CONTROLLER.T = 2
    _C.CONTROLLER.C = 2.5
    _C.CONTROLLER.NUM_MAGS = 10
    _C.CONTROLLER.EXCLUDE_OPS_NUM = 0
    _C.CONTROLLER.EXCLUDE_OPS = []

    _C.DISCRIMINATOR = CfgNode()
    _C.DISCRIMINATOR.NAME = "momentum_feature"

    _C.DATASET = CfgNode()
    _C.DATASET.ROOT = "./dataset"
    _C.DATASET.NAME = "cifar10"
    _C.DATASET.TRAINSET = ""
    _C.DATASET.TESTSET = ""
    _C.DATASET.DG = CfgNode()
    _C.DATASET.DG.TRAIN = [1, 2, 3]
    _C.DATASET.DG.TEST = [4]

    _C.TRAIN = CfgNode()
    _C.TRAIN.LR = 0.1
    _C.TRAIN.WD = 0.0004
    _C.TRAIN.BEGIN_EPOCH = 0
    _C.TRAIN.WARMUP_EPOCH = 0
    _C.TRAIN.END_EPOCH = 200
    _C.TRAIN.BATCH_SIZE = 8
    _C.TRAIN.SHUFFLE = True

    _C.TEST = CfgNode()
    _C.TEST.BATCH_SIZE = 8
    _C.TEST.MODEL_DIR = ""

    # The JAX package's additions. The port reads DATA_PARALLEL (must be 1
    # or -1 for now), COMPUTE_DTYPE, STEPS_PER_EPOCH, SINKHORN, CROP_SIZE
    # and SYNTHETIC_SIZE; the rest are kept so every experiment file loads.
    _C.TPU = CfgNode()
    _C.TPU.DATA_PARALLEL = -1
    _C.TPU.COMPUTE_DTYPE = "bfloat16"
    _C.TPU.STEPS_PER_EPOCH = 0
    _C.TPU.SCAN_EPOCH = True
    _C.TPU.PALLAS_SINKHORN = True
    _C.TPU.SINKHORN = CfgNode()
    _C.TPU.SINKHORN.BLUR = 0.05
    _C.TPU.SINKHORN.SCALING = 0.5
    _C.TPU.SINKHORN.DEBIAS = True
    _C.TPU.CROP_SIZE = 256
    _C.TPU.SYNTHETIC_SIZE = 64
    _C.TPU.CHECKPOINT_FREQ = 1
    _C.TPU.AUTO_RESUME = False
    _C.TPU.AUTOAUGMENT = False
    _C.TPU.PROFILE = False
    _C.TPU.REMAT = False
    _C.TPU.PRETRAINED = ""

    return _C


def load_config(cfg_file: str | None = None,
                opts: List[Any] | None = None) -> CfgNode:
    cfg = default_config()
    if cfg_file:
        cfg.merge_from_file(cfg_file)
    if opts:
        cfg.merge_from_list(opts)
    return cfg
