"""The port's transforms, soft labels, datasets and batch gather against the
JAX package, given the same draws.

Scale-crop images: atol 1e-4 on values in [0, 255] (both sides are f32
matrix products of the same weights, summed in a different order), and
for the rvs scales in [0.5, 2] rtol 1e-5 besides; the weight matrices
within 1e-6; masks, labels, soft labels, datasets (the optic and vessel
pools, ROIs included), epoch lengths and gathers: exact.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aadg_tpu.config import load_config as jax_load_config
from aadg_tpu.data import datasets as jds
from aadg_tpu.data import stores as jstores
from aadg_tpu.data import transforms as jtr
from aadg_tpu_torch.config import load_config
from aadg_tpu_torch.data import datasets as tds
from aadg_tpu_torch.data import stores as tstores
from aadg_tpu_torch.data import transforms as ttr
from torch_port_helpers import scale_crop_draws, soft_label_draws
from torch_port_helpers import few_torch_threads  # noqa: F401


def _draw(sw, sh, ux, uy):
    return ttr.ScaleCropDraw(*(torch.from_numpy(a) for a in (sw, sh, ux, uy)))


def test_random_scale_crop_matches_jax():
    rng = np.random.default_rng(0)
    n, size, crop = 12, 40, 32
    imgs = rng.integers(0, 256, (n, size, size, 3)).astype(np.float32)
    masks = rng.choice([0.0, 128.0, 255.0], (n, size, size)).astype(
        np.float32)
    keys = jax.random.split(jax.random.PRNGKey(1), n)
    scale_range = (1.0, 1.5)
    # eager: XLA:CPU's jitted einsum rounds differently (up to 1e-3 here)
    # from its own eager result, which agrees with an f32 bmm to 2e-5
    j_img, j_mask = jax.vmap(
        lambda i, m, k: jtr.random_scale_crop(i, m, k, crop, scale_range))(
            imgs, masks, keys)
    draw = _draw(*scale_crop_draws(keys, scale_range))
    assert float(draw.sw.min()) == 1.0 and float(draw.sw.max()) > 1.0
    t_img, t_mask = ttr.random_scale_crop(torch.from_numpy(imgs),
                                          torch.from_numpy(masks), draw, crop)
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))


def test_train_transform_labels_and_normalization():
    rng = np.random.default_rng(1)
    n, size = 4, 32
    imgs = rng.integers(0, 256, (n, size, size, 3)).astype(np.float32)
    masks = rng.choice([0.0, 40.0, 128.0, 201.0, 255.0],
                       (n, size, size)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(2), n)
    jt, _ = jtr.make_train_transform("optic", size)
    jx, jy = jax.vmap(jt)(imgs, masks, keys)
    tt, scale_range = ttr.make_train_transform("optic", size)
    tx, ty = tt(torch.from_numpy(imgs), torch.from_numpy(masks),
                _draw(*scale_crop_draws(keys, scale_range)))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


def test_soft_domain_label_exact():
    n = 9
    dcs = np.arange(n) % 3
    keys = jax.random.split(jax.random.PRNGKey(3), n)
    j = np.asarray(jax.vmap(lambda i, k: jtr.soft_domain_label(i, 3, k))(
        jnp.asarray(dcs), keys))
    t = ttr.soft_domain_label(torch.from_numpy(dcs), 3,
                              torch.from_numpy(soft_label_draws(keys, 3)))
    np.testing.assert_array_equal(t.numpy(), j)


def test_synthetic_dataset_identical():
    cfg = load_config("tests/fixtures/synthetic_optic.yaml")
    jcfg = jax_load_config("tests/fixtures/synthetic_optic.yaml")
    for ta, ja in zip(tds.load_train_arrays(tds.build_dataset(cfg, "train")),
                      jds.load_train_arrays(jds.build_dataset(jcfg, "train"))):
        np.testing.assert_array_equal(ta, ja)
    tint = tds.SyntheticDataset("optic_tint", n_per_domain=3, size=16)
    jtint = jds.SyntheticDataset("optic_tint", n_per_domain=3, size=16)
    for a, b in zip(tint.domains, jtint.domains):
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)


def test_batch_gather_exact():
    rng = np.random.default_rng(4)
    d, nmax, size = 3, 5, 8
    imgs = rng.integers(0, 256, (d, nmax, size, size, 3)).astype(np.uint8)
    labels = rng.integers(0, 256, (d, nmax, size, size)).astype(np.uint8)
    counts = np.array([5, 3, 4], np.int32)
    key = jax.random.PRNGKey(5)
    jstore = jstores.make_train_store(imgs, labels, counts)
    j_i, j_m, j_d = jstores.sample_train_batch(jstore, key, 6)
    idx = np.asarray(jax.random.randint(
        key, (6, d), 0, jnp.broadcast_to(jnp.asarray(counts)[None], (6, d))))
    tstore = tstores.make_train_store(imgs, labels, counts, "cpu")
    t_i, t_m, t_d = tstores.gather_batch(tstore, torch.from_numpy(idx))
    np.testing.assert_array_equal(t_i.numpy(), np.asarray(j_i))
    np.testing.assert_array_equal(t_m.numpy(), np.asarray(j_m))
    np.testing.assert_array_equal(t_d.numpy(), np.asarray(j_d))


def test_draws_in_range():
    gen = torch.Generator().manual_seed(0)
    counts = np.array([5, 3, 4], np.int32)
    store = tstores.make_train_store(
        np.zeros((3, 5, 4, 4, 3), np.uint8), np.zeros((3, 5, 4, 4), np.uint8),
        counts, "cpu")
    idx = tstores.draw_batch_indices(store, 4000, gen)
    assert idx.shape == (4000, 3)
    assert (idx.max(0).values.numpy() == counts - 1).all()
    assert int(idx.min()) == 0
    d = ttr.draw_scale_crop(4000, (1.0, 1.5), gen)
    scaled = d.sw != 1.0
    assert 0.75 < float(scaled.float().mean()) < 0.85
    assert float(d.sw.max()) <= 1.5 and float(d.sh.min()) >= 1.0
    assert store.steps_per_epoch(2) == 3


def test_synthetic_rvs_pools_identical():
    """Vessel pools, labels and ROIs byte for byte, train and test split."""
    opts = ["TPU.SYNTHETIC_SIZE", "48"]
    cfg = load_config("tests/fixtures/synthetic_rvs.yaml", opts)
    jcfg = jax_load_config("tests/fixtures/synthetic_rvs.yaml", opts)
    for phase in ("train", "test"):
        t, j = tds.build_dataset(cfg, phase), jds.build_dataset(jcfg, phase)
        assert len(t.domains) == len(j.domains) == (3 if phase == "train"
                                                    else 1)
        for a, b in zip(t.domains, j.domains):
            for name in ("images", "labels", "rois"):
                np.testing.assert_array_equal(getattr(a, name),
                                              getattr(b, name))
            assert a.names == b.names and a.images.shape[1] == 48
    for ta, ja in zip(tds.load_test_arrays(t), jds.load_test_arrays(j)):
        if isinstance(ta, list):
            assert ta == ja
        else:
            np.testing.assert_array_equal(ta, ja)
    assert set(np.unique(t.domains[0].labels)) == {0, 255}
    assert set(np.unique(t.domains[0].rois)) == {0, 255}


@pytest.mark.parametrize("length_mult", [1, 3])
@pytest.mark.parametrize("batch_size", [2, 5, 8])
def test_steps_per_epoch_equals_jax(length_mult, batch_size):
    counts = np.array([7, 12, 9], np.int32)
    imgs = np.zeros((3, 12, 4, 4, 3), np.uint8)
    labels = np.zeros((3, 12, 4, 4), np.uint8)
    got = tstores.make_train_store(imgs, labels, counts, "cpu")
    want = jstores.make_train_store(imgs, labels, counts)
    assert got.steps_per_epoch(batch_size, length_mult) == \
        want.steps_per_epoch(batch_size, length_mult)


@pytest.mark.parametrize("name, mult", [("rvs", 3), ("synthetic_rvs", 1),
                                        ("synthetic_optic", 1)])
def test_load_stores_epoch_length(monkeypatch, name, mult):
    """The epoch length's multiplier compares the raw dataset name, as the
    JAX loops do: x3 for ``rvs`` (its disk pools), x1 for synthetic_rvs."""
    from aadg_tpu_torch.engine import search as tsearch
    fixture = ("tests/fixtures/synthetic_optic.yaml" if "optic" in name
               else "tests/fixtures/synthetic_rvs.yaml")
    cfg = load_config(fixture, ["DATASET.NAME", name, "TPU.STEPS_PER_EPOCH",
                                "0", "TRAIN.BATCH_SIZE", "5"])
    pools = tds.SyntheticDataset("rvs" if "rvs" in name else "optic",
                                 n_per_domain=12, size=16)
    monkeypatch.setattr(tsearch, "build_dataset", lambda cfg, phase: pools)
    _, _, steps = tsearch.load_stores(cfg, "cpu")
    assert steps == math.ceil(12 * mult / 5)


def test_vessel_and_roi_labels_exact():
    rng = np.random.default_rng(6)
    m = rng.choice([0.0, 1.0, 128.0, 255.0], (3, 9, 7)).astype(np.float32)
    for jf, tf in ((jtr.vessel_mask_to_binary, ttr.vessel_mask_to_binary),
                   (jtr.roi_to_binary, ttr.roi_to_binary)):
        got = tf(torch.from_numpy(m))
        assert got.shape == (3, 9, 7, 1) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jf(m)))


def test_rvs_train_transform_with_downscale_matches_jax():
    """The rvs transform at a 64² pool and crop 32: scales in [0.5, 2], so
    some draws shrink the image (the antialiased branch, kernel wider than
    one pixel) and some crops start at the left or top edge. Images within
    rtol 1e-5 / atol 1e-4 of eager JAX, labels exact."""
    rng = np.random.default_rng(7)
    n, size, crop = 24, 64, 32
    imgs = rng.integers(0, 256, (n, size, size, 3)).astype(np.float32)
    masks = rng.choice([0.0, 255.0], (n, size, size)).astype(np.float32)
    tt, scale_range = ttr.make_train_transform("rvs", crop)
    assert scale_range == (0.5, 2.0)
    for seed in range(100):  # the first key tree with a downscaled crop
        keys = jax.random.split(jax.random.PRNGKey(seed), n)  # at x = 0
        draw = _draw(*scale_crop_draws(keys, scale_range))
        new_w = np.floor(draw.sw.numpy() * size)
        x1 = np.floor(draw.ux.numpy() * (new_w - crop + 1.0))
        if ((x1 == 0) & (new_w < size)).any():
            break
    assert float(draw.sw.min()) < 1.0 and float(draw.sh.min()) < 1.0
    assert float(draw.sw.max()) > 1.5
    jt, _ = jtr.make_train_transform("rvs", crop)
    jx, jy = jax.vmap(jt)(imgs, masks, keys)
    tx, ty = tt(torch.from_numpy(imgs), torch.from_numpy(masks), draw)
    assert tuple(ty.shape) == (n, crop, crop, 1)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5,
                               atol=1e-4 / 127.5)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


def test_downscale_weights_match_jax():
    """The antialiased weight matrices themselves, scale 0.5-1 with the
    crop at the border, against ``compute_weight_mat``."""
    from jax._src.image import scale as jscale
    size, crop = 64, 32
    scales = np.array([0.5, 0.515625, 0.75, 0.984375, 1.0, 1.6], np.float32)
    offsets = np.array([0.0, 1.0, 0.0, 30.0, 17.0, 70.0], np.float32)
    got = ttr.linear_weight_mat(size, crop, torch.from_numpy(scales),
                                torch.from_numpy(-offsets)).numpy()
    for i, (s, o) in enumerate(zip(scales, offsets)):
        want = np.asarray(jscale.compute_weight_mat(
            size, crop, jnp.float32(s), jnp.float32(-o),
            jscale._fill_triangle_kernel, True))
        np.testing.assert_allclose(got[i], want, rtol=0, atol=1e-6,
                                   err_msg=str(s))


def test_rvs_transform_asserts_scale_covers_crop():
    tt, _ = ttr.make_train_transform("rvs", 32)
    draw = _draw(*(np.ones(2, np.float32),) * 2, *(np.zeros(2, np.float32),) * 2)
    imgs, masks = torch.zeros(2, 48, 48, 3), torch.zeros(2, 48, 48)
    with pytest.raises(AssertionError,
                       match=r"scale_range \(0.5, 2.0\) x size 48 < crop 32"):
        tt(imgs, masks, draw)
    jt, _ = jtr.make_train_transform("rvs", 32)
    with pytest.raises(AssertionError,
                       match=r"scale_range \(0.5, 2.0\) x size 48 < crop 32"):
        jt(jnp.zeros((48, 48, 3)), jnp.zeros((48, 48)),
           jax.random.PRNGKey(0))
