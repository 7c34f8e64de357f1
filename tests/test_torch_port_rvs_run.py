"""The port's entry point on the rvs task, end to end on the CPU: the JAX
package's rvs fixture (``tests/fixtures/synthetic_rvs.yaml``: UNet, one
class, REINFORCE, M=2, B=2, crop 32 from 64² vessel pools) unchanged.

``--mode search`` (1 warmup + 2 search epochs of 2 steps, rvs validation
every epoch), ``--mode train TPU.AUTOAUGMENT True`` from the search run,
then ``--mode test --output_type seg`` from the train run: its per-image
F1 within 1e-3 of ``aadg_tpu``'s ``run_test`` on the same weights (the
trained model carried to flax), and its PNG maps equal to the JAX model's
probabilities thresholded at 0.5 (a pixel may differ only where the two
probabilities straddle the threshold within 1e-5).
"""

import csv
import json
import math
from pathlib import Path

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aadg_tpu import utils as jutils
from aadg_tpu.config import load_config as jax_load_config
from aadg_tpu.engine import state as jstate
from aadg_tpu.engine import test as jtest
from aadg_tpu_torch import run as trun
from aadg_tpu_torch.config import load_config
from aadg_tpu_torch.engine import state as tstate
from aadg_tpu_torch.engine import test as ttest
from torch_port_helpers import few_torch_threads  # noqa: F401
from torch_port_helpers import to_flax

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = str(ROOT / "tests/fixtures/synthetic_rvs.yaml")
RVS_KEYS = ["dsc", "acc", "aucroc", "sp", "se"]


def _main(tmp_path, *args):
    return trun.main(["--cfg", FIXTURE, "--device", "cpu", "--output_dir",
                      str(tmp_path / "output"), *args, "LOG_DIR",
                      str(tmp_path / "log")])


def _check_rvs_result(path: Path) -> dict:
    res = json.loads(path.read_text())
    assert list(res) == ["epoch", *RVS_KEYS]
    for k in RVS_KEYS:
        assert math.isfinite(res[k]) and 0.0 <= res[k] <= 1.0, (k, res)
    return res


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rvs_chain")
    search = _main(tmp)
    train = _main(tmp, "--mode", "train", "TPU.AUTOAUGMENT", "True",
                  "TEST.MODEL_DIR", search["out_dir"])
    return tmp, search, train


def test_rvs_search_and_train(chain):
    _, search, train = chain
    assert [e["kind"] for e in search["epochs"]] == ["warmup", "search",
                                                     "search"]
    assert search["steps_per_epoch"] == 2
    assert search["images_per_search_step"] == 2 * 3 * 2
    for e in search["epochs"] + train["epochs"]:
        assert "dsc" in e["metrics"] and "cup_dsc" not in e["metrics"]
        assert all(math.isfinite(v) for v in e["metrics"].values()), e
        assert list(e["valid"]) == RVS_KEYS
        assert all(math.isfinite(v) for v in e["valid"].values()), e
    out = Path(search["out_dir"])
    log = (out / "train.log").read_text()
    assert "Test Epoch 2 dsc:" in log and " aucroc:" in log
    assert (out / "checkpoint_2.pt").exists()
    assert _check_rvs_result(out / "final_result.json") == \
        search["best_metric"]
    assert len(train["train_step_seconds"]) == 3 * 2
    assert "autoaugment: loaded controller" in (
        Path(train["out_dir"]) / "train.log").read_text()
    _check_rvs_result(Path(train["out_dir"]) / "final_result.json")


def test_rvs_test_seg_matches_jax_run_test(chain, monkeypatch):
    tmp, _, train = chain
    vis = tmp / "port_vis"
    got = _main(tmp, "--mode", "test", "--output_type", "seg", "--vis_dir",
                str(vis), "TEST.MODEL_DIR", train["out_dir"])
    assert list(got) == ["name", "f1_score"] and len(got["name"]) == 4
    with open(vis / "test_result.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert [r["name"] for r in rows] == got["name"]
    np.testing.assert_allclose([float(r["f1_score"]) for r in rows],
                               got["f1_score"], rtol=1e-6)

    # the weights the port's test mode loaded, carried to flax
    cfg = load_config(FIXTURE)
    model = tstate.build_entities(cfg, "train", device="cpu").make_model()
    ttest.load_model_state(model, train["out_dir"], logger=lambda m: None)
    jcfg = jax_load_config(FIXTURE)
    jent = jstate.build_entities(jcfg, "train", steps_per_epoch=1)
    template = jax.jit(lambda k: jent.model.init(
        k, jnp.zeros((1, 32, 32, 3)), train=False))(jax.random.PRNGKey(0))
    weights = to_flax(model.state_dict(), template)
    jdir = tmp / "jax_run"
    jutils.save_checkpoint(weights, False, str(jdir), "final_state.msgpack",
                           update_latest=False)
    sd = jstate.SegDisState(weights["params"], weights["batch_stats"],
                            None, None, None, None)
    # run_test's template state: the checkpoint replaces its weights
    monkeypatch.setattr(jtest, "init_state", lambda ent, key: (sd, None))
    probs, make_fwd = [], jtest.make_eval_forward

    def recording_forward(ent):
        fwd = make_fwd(ent)

        def call(*args):
            out = fwd(*args)
            probs.append(np.asarray(out))
            return out
        return call
    monkeypatch.setattr(jtest, "make_eval_forward", recording_forward)
    want = jtest.run_test(jax_load_config(FIXTURE, ["TEST.MODEL_DIR",
                                                    str(jdir)]),
                          FIXTURE, vis_dir=str(tmp / "jax_vis"),
                          output_type="seg")
    assert list(want) == list(got) and want["name"] == got["name"]
    np.testing.assert_allclose(got["f1_score"], want["f1_score"], rtol=0,
                               atol=1e-3)
    assert max(want["f1_score"]) > 0.05  # the maps are not empty
    # the JAX model's probabilities at the port's weights
    p_all = np.concatenate(probs)[:len(want["name"]), ..., 0]
    for name, p in zip(want["name"], p_all):
        mine = imageio.imread(vis / (name[:-3] + "png"))
        assert mine.dtype == np.uint8 and set(np.unique(mine)) <= {0, 255}
        ref = ((p > 0.5) * 255).astype(np.uint8)
        differ = mine != ref
        assert not np.any(differ & (np.abs(p - 0.5) > 1e-5)), name


def test_rvs_test_image_mode(chain):
    tmp, search, _ = chain
    img_dir = tmp / "vis_img"
    res = _main(tmp, "--mode", "test", "--output_type", "image",
                "--vis_dir", str(img_dir), "TEST.MODEL_DIR",
                search["out_dir"])
    assert res == {"n_images": 32}
    img = imageio.imread(img_dir / "sample0_0.png")
    assert img.shape == (64, 64, 3) and img.dtype == np.uint8
