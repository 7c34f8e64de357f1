"""The port's validation against ``aadg_tpu/engine/evaluate.py`` on the
synthetic optic test split at 64² (1 domain, 4 images), from the same
weights (the JAX init of ``torch_port_helpers.step_pair`` with a sharpened
segmentation head, so the 0.75 threshold gives masks of both classes).

Tolerances: eval-forward probabilities within 1e-5 (f32 model; measured
6e-7); ``validate_optic`` end to end within 1e-3 in dice and 1 pixel in
hd95 (a probability next to the threshold may fall on the other side); on
identical hard masks the numbers are equal, since the counts are exact in
f32 and hd95 runs the same numpy code.

RVS: the JAX package's rvs fixture (UNet, one class) at 64² with its 4
test images and ROIs, weights carried by ``from_flax``: eval-forward
probabilities within 1e-5, and ``validate_rvs`` (weighted dice at 0.5, ROI
accuracy, AUROC, specificity and sensitivity) within 1e-5 of the JAX
function in every metric.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aadg_tpu.config import load_config as jax_load_config
from aadg_tpu.data import datasets as jdatasets
from aadg_tpu.data import stores as jstores
from aadg_tpu.engine import evaluate as jev
from aadg_tpu.engine import state as jstate
from aadg_tpu_torch.config import load_config
from aadg_tpu_torch.data import datasets as tdatasets
from aadg_tpu_torch.data import stores as tstores
from aadg_tpu_torch.engine import evaluate as tev
from aadg_tpu_torch.engine import state as tstate
from aadg_tpu_torch.weights import from_flax
from torch_port_helpers import few_torch_threads  # noqa: F401
from torch_port_helpers import (CFG, OPTS, _np, port_state,
                                sharpen_seg_head, step_pair)

RVS_FIXTURE = "tests/fixtures/synthetic_rvs.yaml"


@pytest.fixture(scope="module")
def setup():
    jent, sd, tent, _ = step_pair()
    sd = sharpen_seg_head(sd)
    tsd = port_state(tent, sd)
    arrays = tdatasets.load_test_arrays(
        tdatasets.build_dataset(load_config(CFG, OPTS), "test"))
    return jent, sd, tent, tsd, arrays


def _stores(arrays, batch_size):
    return (jstores.make_test_store(*arrays, batch_size=batch_size),
            tstores.make_test_store(*arrays, batch_size=batch_size,
                                    device="cpu"))


def test_load_test_arrays_equal_jax(setup):
    got = setup[4]
    want = jdatasets.load_test_arrays(jdatasets.build_dataset(
        jax_load_config(CFG, OPTS), "test"))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    assert got[2] is None and want[2] is None
    assert got[3] == want[3] and len(got[3]) == 4


@pytest.mark.parametrize("batch_size", [3, 4, 8])
def test_test_store_equals_jax(setup, batch_size):
    jst, tst = _stores(setup[4], batch_size)
    assert tst.images.shape[0] % batch_size == 0
    for name in ("images", "labels", "weights"):
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      np.asarray(getattr(jst, name)))
    assert tst.rois is None and tst.names == jst.names and tst.n_real == 4


def test_eval_forward_matches_jax(setup):
    jent, sd, tent, tsd, arrays = setup
    imgs = arrays[0]
    got = tev.eval_forward(tent, tsd.model, torch.from_numpy(imgs)).numpy()
    want = np.asarray(jev.make_eval_forward(jent)(
        sd.seg_params, sd.seg_stats, jnp.asarray(imgs)))
    assert got.shape == want.shape == imgs.shape[:3] + (2,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the sharpened head puts pixels on both sides of the threshold
    assert 0.01 < float((want > 0.75).mean()) < 0.99
    assert not tsd.model.training


def test_validate_optic_matches_jax(setup):
    jent, sd, tent, tsd, arrays = setup
    jst, tst = _stores(arrays, 4)
    got = tev.validate(tent, tsd.model, tst, 4)
    want = jev.validate(jent, sd, jst, 4)
    assert set(got) == set(want) == {"cup_dsc", "disc_dsc", "cup_hd",
                                     "disc_hd"}
    for k in ("cup_dsc", "disc_dsc"):
        assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])
    for k in ("cup_hd", "disc_hd"):
        assert abs(got[k] - want[k]) <= 1.0, (k, got[k], want[k])
    assert all(0.0 <= got[k] <= 1.0 for k in ("cup_dsc", "disc_dsc"))
    assert all(0.0 <= got[k] <= 100.0 for k in ("cup_hd", "disc_hd"))


def _fake_probs(imgs: np.ndarray, no_cup: np.ndarray) -> np.ndarray:
    """Probabilities from the image alone: bright pixels are disc, the
    brightest cup; image ``no_cup`` has an empty cup (the hd95 penalty)."""
    luma = imgs.astype(np.float32).mean(-1)
    thr = np.percentile(luma, 75, axis=(1, 2), keepdims=True)
    disc = (luma > thr).astype(np.float32)
    cup = (luma > thr + 30).astype(np.float32)
    cup[np.all(imgs == no_cup, axis=(1, 2, 3))] = 0.0
    return np.stack([0.1 + 0.8 * cup, 0.1 + 0.8 * disc], -1)


@pytest.fixture
def same_masks(setup, monkeypatch):
    """Both packages' forwards return ``_fake_probs`` of their batch."""
    no_cup = setup[4][0][-1]
    monkeypatch.setattr(jev, "make_eval_forward", lambda ent: (
        lambda params, stats, imgs: jnp.asarray(_fake_probs(
            np.asarray(imgs), no_cup))))
    monkeypatch.setattr(tev, "eval_forward", lambda ent, model, imgs: (
        torch.from_numpy(_fake_probs(imgs.numpy(), no_cup))))


@pytest.mark.parametrize("batch_size", [2, 3, 4])
def test_validate_optic_equals_jax_on_same_masks(setup, same_masks,
                                                 batch_size):
    jent, sd, tent, tsd, arrays = setup
    jst, tst = _stores(arrays, batch_size)
    got = tev.validate_optic(tent, tsd.model, tst, batch_size)
    want = jev.validate_optic(jent, sd, jst, batch_size)
    assert got == want
    assert got["cup_hd"] > 25.0  # one empty cup scores the 100 penalty


def test_validate_optic_weights_padding_out(setup, same_masks):
    """4 images in batches of 3: the store pads to 6 rows with weight 0,
    and the result is the unpadded one."""
    jent, sd, tent, tsd, arrays = setup
    _, padded = _stores(arrays, 3)
    _, whole = _stores(arrays, 4)
    assert padded.weights.tolist() == [1, 1, 1, 1, 0, 0]
    got = tev.validate_optic(tent, tsd.model, padded, 3)
    want = tev.validate_optic(tent, tsd.model, whole, 4)
    for k in ("cup_dsc", "disc_dsc"):
        assert got[k] == pytest.approx(want[k], rel=0, abs=1e-6)
    for k in ("cup_hd", "disc_hd"):
        assert got[k] == want[k]


def test_validate_raises_for_rvs(setup):
    """rvs validation reads the store's ROIs: the optic store has none."""
    tent = setup[2]._replace(dataset_name="rvs")
    _, tst = _stores(setup[4], 4)
    with pytest.raises(ValueError, match="ROIs"):
        tev.validate(tent, setup[3].model, tst)


@pytest.fixture(scope="module")
def rvs_setup():
    """The JAX package's rvs fixture (UNet, one class) at 64²: JAX
    entities and weights with a sharpened head, the port's entities and
    model from the same weights, and the rvs test arrays (4 images with
    ROIs)."""
    jcfg = jax_load_config(RVS_FIXTURE)
    jent = jstate.build_entities(jcfg, "search", steps_per_epoch=1)
    variables = jax.jit(lambda k: jent.model.init(
        k, jnp.zeros((1, 32, 32, 3)), train=False))(jax.random.PRNGKey(3))
    params, stats = _np(variables["params"]), _np(variables["batch_stats"])
    cfg = load_config(RVS_FIXTURE)
    arrays = tdatasets.load_test_arrays(tdatasets.build_dataset(cfg, "test"))
    # at init every probability sits within 0.02 of 0.5: scale the 1x1
    # head and centre its bias on the median logit, so the 0.5 threshold
    # splits the pixels
    p = np.asarray(jev.make_eval_forward(jent)(params, stats,
                                               jnp.asarray(arrays[0])))
    median = float(np.median(np.log(p / (1 - p))))
    gain = np.float32(50.0)
    params["Conv_0"] = {"kernel": params["Conv_0"]["kernel"] * gain,
                        "bias": np.full_like(params["Conv_0"]["bias"],
                                             -gain * median)}
    jsd = jstate.SegDisState(params, stats, None, None, None, None)
    tent = tstate.build_entities(cfg, "search", device="cpu")
    model = tent.make_model()
    model.load_state_dict(from_flax({"params": params,
                                     "batch_stats": stats}), strict=True)
    return jent, jsd, tent, model, arrays


def test_rvs_eval_forward_matches_jax(rvs_setup):
    jent, jsd, tent, model, arrays = rvs_setup
    imgs = arrays[0]
    got = tev.eval_forward(tent, model, torch.from_numpy(imgs)).numpy()
    want = np.asarray(jev.make_eval_forward(jent)(
        jsd.seg_params, jsd.seg_stats, jnp.asarray(imgs)))
    assert got.shape == want.shape == imgs.shape[:3] + (1,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert 0.01 < float((want > 0.5).mean()) < 0.99


@pytest.mark.parametrize("batch_size", [3, 4])
def test_validate_rvs_matches_jax(rvs_setup, batch_size):
    jent, jsd, tent, model, arrays = rvs_setup
    assert arrays[2] is not None and arrays[2].shape == arrays[1].shape
    jst, tst = _stores(arrays, batch_size)
    np.testing.assert_array_equal(tst.rois.numpy(), np.asarray(jst.rois))
    got = tev.validate(tent, model, tst, batch_size)
    want = jev.validate(jent, jsd, jst, batch_size)
    assert list(got) == list(want) == ["dsc", "acc", "aucroc", "sp", "se"]
    for k in want:
        assert math.isfinite(got[k]) and 0.0 <= got[k] <= 1.0, (k, got)
        assert abs(got[k] - want[k]) <= 1e-5, (k, got[k], want[k])
