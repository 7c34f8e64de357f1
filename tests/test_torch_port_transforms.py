"""The port's transforms, soft labels, datasets and batch gather against the
JAX package, given the same draws.

Scale-crop images: atol 1e-4 on values in [0, 255] (both sides are f32
matrix products of the same weights, summed in a different order); masks,
labels, soft labels, datasets and gathers: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
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
