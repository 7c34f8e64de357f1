"""The port's YAML reader and config tree against PyYAML and the JAX
package's config, plus the port's import boundary and entry point."""

import ast
import glob
from pathlib import Path

import pytest
import torch
import yaml

from aadg_tpu.config import default_config as jax_default_config
from aadg_tpu.config import load_config as jax_load_config
from aadg_tpu_torch import config as tcfg
from aadg_tpu_torch import run as trun
from torch_port_helpers import few_torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
YAMLS = sorted(glob.glob(str(ROOT / "experiments" / "**" / "*.yaml"),
                         recursive=True)
               + glob.glob(str(ROOT / "tests" / "fixtures" / "*.yaml")))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "aadg_tpu")


def _plain(node):
    if isinstance(node, dict):
        return {k: _plain(v) for k, v in node.items()}
    return node


@pytest.mark.parametrize("path", YAMLS, ids=lambda p: Path(p).name)
def test_yaml_reader_equals_pyyaml(path):
    text = Path(path).read_text()
    assert tcfg.parse_yaml(text) == yaml.safe_load(text)
    assert _plain(tcfg.load_config(path)) == _plain(jax_load_config(path))


def test_yaml_reader_scalars_and_errors():
    text = ("A: 1\nB: 2.5\nC: 1e-5\nD: 'q # r'\nE: [1, 'x', [2, 3]]\n"
            "F: yes\nG: null\nH:\n  I: -3  # comment\n  J: .inf\nK:\n")
    assert tcfg.parse_yaml(text) == yaml.safe_load(text)
    with pytest.raises(ValueError):
        tcfg.parse_yaml("A:\n  - 1\n")


def test_default_config_equals_jax():
    assert _plain(tcfg.default_config()) == _plain(jax_default_config())


def test_overrides_and_freeze():
    cfg = tcfg.load_config(str(ROOT / "experiments/optic_sinkhorn/"
                                      "diversity.yaml"),
                           ["TRAIN.BATCH_SIZE", "4", "DATASET.DG.TRAIN",
                            "[1, 2]", "TPU.SINKHORN.DEBIAS", "false"])
    assert cfg.TRAIN.BATCH_SIZE == 4 and cfg.DATASET.DG.TRAIN == [1, 2]
    assert cfg.TPU.SINKHORN.DEBIAS is False
    with pytest.raises(KeyError):
        cfg.merge_from_list(["TRAIN.NOPE", "1"])
    cfg.freeze()
    with pytest.raises(AttributeError):
        cfg.TRAIN.LR = 1.0
    assert "BATCH_SIZE: 4" in cfg.dump()


def _port_sources():
    files = sorted((ROOT / "aadg_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_entry_point_refuses_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        trun.main(["--cfg", str(ROOT / "tests/fixtures/synthetic_optic.yaml")])
    assert trun.resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("mode", ["train", "test"])
def test_entry_point_dispatches_train_and_test(monkeypatch, mode):
    from aadg_tpu_torch.engine import test as ttest
    from aadg_tpu_torch.engine import train as ttrain
    calls = []
    monkeypatch.setattr(ttrain, "run_train", lambda cfg, path, **kw: (
        calls.append(("train", cfg, path, kw)) or "trained"))
    monkeypatch.setattr(ttest, "run_test", lambda cfg, path, **kw: (
        calls.append(("test", cfg, path, kw)) or "tested"))
    cfg_path = str(ROOT / "experiments/optic_sinkhorn/diversity.yaml")
    out = trun.main(["--cfg", cfg_path, "--device", "cpu", "--mode", mode,
                     "--vis_dir", "v", "--output_type", "seg", "--seed",
                     "7", "TEST.MODEL_DIR", "runs/x"])
    assert out == mode + "ed" and len(calls) == 1
    called, cfg, path, kw = calls[0]
    assert called == mode and path == cfg_path and cfg.SEED == 7
    assert cfg.TEST.MODEL_DIR == "runs/x" and kw["device"].type == "cpu"
    if mode == "test":
        assert kw == {"vis_dir": "v", "output_type": "seg", "seed": 7,
                      "device": kw["device"]}


@pytest.mark.parametrize("mode", ["train", "test"])
def test_train_and_test_modes_refuse_missing_card(monkeypatch, mode):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        trun.main(["--cfg", str(ROOT / "experiments/optic_sinkhorn/"
                                "diversity.yaml"), "--mode", mode])


def test_entry_point_rejects_unknown_mode():
    with pytest.raises(NotImplementedError, match="search / train / test"):
        trun.main(["--cfg", str(ROOT / "tests/fixtures/synthetic_optic.yaml"),
                   "--device", "cpu", "--mode", "export"])


def _entry_functions():
    from aadg_tpu_torch.engine import search, state, test, train
    return [state.build_entities, search.run_search, train.run_train,
            test.run_test]


@pytest.mark.parametrize("fn", _entry_functions(),
                         ids=lambda f: f.__name__)
def test_entry_functions_default_to_the_card(fn):
    import inspect
    assert inspect.signature(fn).parameters["device"].default == "cuda"
