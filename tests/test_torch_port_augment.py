"""The port's augmentation == the JAX package's, bit for bit.

Every search-space op at every magnitude index, the fused switcher for
every op, the batched multi-policy applier, and the plain histogram / LUT
apply against the Pallas kernels in interpret mode and the jnp one-hot
path. Comparisons are exact (np.array_equal): the ops are integer-exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from aadg_tpu.ops import augment as jaug
from aadg_tpu.ops import lut_pallas
from aadg_tpu_torch.ops import augment as taug
from aadg_tpu_torch.ops import lut as tlut
from torch_port_helpers import policy_draws
from torch_port_helpers import few_torch_threads  # noqa: F401

H = W = 32
NAMES = jaug.augment_list()
OP_SEEDS = {n: i for i, n in enumerate(NAMES)}


def _images(rng, n):
    """Integer images with varied ranges, incl. a constant one."""
    out = []
    for i in range(n):
        lo = int(rng.integers(0, 120))
        hi = int(rng.integers(lo + 1, 257))
        out.append(rng.integers(lo, hi, (H, W, 3)))
    out[0][:] = 77  # degenerate: hi == lo for AutoContrast
    return np.stack(out).astype(np.float32)


def _masks(rng, n):
    return rng.choice([0.0, 128.0, 255.0], (n, H, W)).astype(np.float32)


def _magnitudes(name):
    """v for magnitude indices 0..9 as the switcher computes it, in f32."""
    _, _, low, high = jaug.OP_TABLE[jaug.OP_INDEX[name]]
    level = np.arange(10, dtype=np.float32) / np.float32(9)
    return level * (np.float32(high) - np.float32(low)) + np.float32(low)


def _cutout_centres(keys):
    def one(k):
        kx, ky = jax.random.split(k)
        return jnp.stack([jax.random.uniform(kx, (), minval=0.0, maxval=W),
                          jax.random.uniform(ky, (), minval=0.0, maxval=H)])
    return np.array(jax.vmap(one)(keys), np.float32)


@pytest.mark.parametrize("name", NAMES)
def test_op_every_magnitude(name):
    rng = np.random.default_rng(OP_SEEDS[name])
    imgs, masks = _images(rng, 10), _masks(rng, 10)
    v = _magnitudes(name)
    keys = jax.random.split(jax.random.PRNGKey(3), 10)
    fn = jaug.OP_TABLE[jaug.OP_INDEX[name]][1]
    j_img, j_mask = jax.jit(jax.vmap(fn))(imgs, masks, v, keys)
    t_fn = taug.OP_TABLE[taug.OP_INDEX[name]][1]
    t_img, t_mask = t_fn(torch.from_numpy(imgs), torch.from_numpy(masks),
                         torch.from_numpy(v),
                         torch.from_numpy(_cutout_centres(keys)))
    np.testing.assert_array_equal(t_img.numpy(), np.asarray(j_img))
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))


def test_fused_switcher_every_op():
    """All 10 ops x 10 magnitudes in one batch of 100 images."""
    rng = np.random.default_rng(11)
    n = 100
    imgs, masks = _images(rng, n), _masks(rng, n)
    op_idx = np.repeat(np.arange(10), 10).astype(np.int32)
    level = (np.tile(np.arange(10), 10).astype(np.float32) / np.float32(9))
    keys = jax.random.split(jax.random.PRNGKey(5), n)
    jsw = jaug.make_fused_op_switcher(NAMES, use_pallas=False)
    j_img, j_mask = jax.jit(jax.vmap(jsw))(op_idx, level, imgs, masks, keys)
    tsw = taug.make_fused_op_switcher(NAMES)
    t_img, t_mask = tsw(torch.from_numpy(op_idx.astype(np.int64)),
                        torch.from_numpy(level), torch.from_numpy(imgs),
                        torch.from_numpy(masks),
                        torch.from_numpy(_cutout_centres(keys)))
    np.testing.assert_array_equal(t_img.numpy(), np.asarray(j_img))
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))


def test_fused_switcher_subset_space():
    """An excluded-op search space keeps the LUT/candidate bookkeeping
    aligned with the JAX switcher."""
    names = [n for n in NAMES if n not in ("Equalize", "Color")]
    rng = np.random.default_rng(12)
    n = 40
    imgs, masks = _images(rng, n), _masks(rng, n)
    op_idx = rng.integers(0, len(names), n).astype(np.int32)
    level = rng.integers(0, 10, n).astype(np.float32) / np.float32(9)
    keys = jax.random.split(jax.random.PRNGKey(6), n)
    jsw = jaug.make_fused_op_switcher(names, use_pallas=False)
    j_img, j_mask = jax.jit(jax.vmap(jsw))(op_idx, level, imgs, masks, keys)
    t_img, t_mask = taug.make_fused_op_switcher(names)(
        torch.from_numpy(op_idx.astype(np.int64)), torch.from_numpy(level),
        torch.from_numpy(imgs), torch.from_numpy(masks),
        torch.from_numpy(_cutout_centres(keys)))
    np.testing.assert_array_equal(t_img.numpy(), np.asarray(j_img))
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))


def test_multi_policy_applier():
    rng = np.random.default_rng(13)
    n, M, Q, L = 3, 2, 5, 2
    imgs, masks = _images(rng, n), _masks(rng, n)
    policies = np.stack([rng.integers(0, 10, (M, Q, L)),
                         rng.integers(0, 10, (M, Q, L))],
                        axis=-1).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(7), n)
    japply = jaug.make_multi_policy_applier(NAMES, Q, L, 10)
    j_img, j_mask = jax.jit(japply)(imgs, masks, policies, keys)
    q, centre = policy_draws(keys, M, Q, L, H, W)
    tapply = taug.make_multi_policy_applier(NAMES, Q, L, 10)
    t_img, t_mask = tapply(torch.from_numpy(imgs), torch.from_numpy(masks),
                           torch.from_numpy(policies.astype(np.int64)),
                           taug.PolicyDraw(torch.from_numpy(q),
                                           torch.from_numpy(centre)))
    assert t_img.shape == (n, M, H, W, 3)
    np.testing.assert_array_equal(t_img.numpy(), np.asarray(j_img))
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))


def test_policy_draw_ranges():
    gen = torch.Generator().manual_seed(0)
    d = taug.draw_policy(64, 6, 5, 2, 48, 32, gen)
    assert d.q.shape == (64, 6) and int(d.q.min()) >= 0 and int(d.q.max()) < 5
    assert d.centre.shape == (64, 6, 2, 2)
    assert float(d.centre[..., 0].max()) < 32 and float(
        d.centre[..., 1].max()) < 48 and float(d.centre.min()) >= 0


def test_hist_and_lut_apply_vs_pallas_interpret():
    rng = np.random.default_rng(14)
    img = rng.integers(0, 256, (H, W, 3)).astype(np.float32)
    luts = rng.integers(0, 256, (3, 256)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        j_hist = np.asarray(lut_pallas.hist3_pallas(jnp.asarray(img)))
        j_out = np.asarray(lut_pallas.lut_apply3_pallas(jnp.asarray(img),
                                                        jnp.asarray(luts)))
    t_img = torch.from_numpy(img)[None]
    np.testing.assert_array_equal(tlut.hist3(t_img)[0].numpy(), j_hist)
    np.testing.assert_array_equal(
        tlut.lut_apply3(t_img, torch.from_numpy(luts)[None])[0].numpy(), j_out)


def test_hist_and_lut_apply_vs_jnp_path():
    """The JAX nibble one-hot histogram + LUT application, per channel."""
    rng = np.random.default_rng(15)
    img = rng.integers(0, 256, (H, W, 3)).astype(np.float32)
    luts = rng.integers(0, 256, (3, 256)).astype(np.int32)
    seen = []

    def make_lut(c):
        def f(hist):
            seen.append(hist)
            return jnp.asarray(luts[c])
        return f

    j_out = np.stack([np.asarray(jaug._hist_and_apply_lut(
        jnp.asarray(img[..., c]), make_lut(c))) for c in range(3)], axis=-1)
    j_hist = np.stack([np.asarray(h) for h in seen])
    t_img = torch.from_numpy(img)[None]
    np.testing.assert_array_equal(tlut.hist3(t_img)[0].numpy(),
                                  j_hist.astype(np.float32))
    np.testing.assert_array_equal(
        tlut.lut_apply3(t_img, torch.from_numpy(luts.astype(np.float32))[None]
                        )[0].numpy(), j_out)


def test_equalize_lut_matches_jax():
    rng = np.random.default_rng(16)
    hists = rng.integers(0, 40, (20, 256)).astype(np.int32)
    hists[rng.random((20, 256)) < 0.6] = 0
    hists[0] = 0
    hists[0, 17] = 900  # a single occupied bin: step 0, identity LUT
    total = 4096
    j = np.stack([np.asarray(jaug._equalize_lut(jnp.asarray(h), total))
                  for h in hists])
    t = taug.equalize_lut(torch.from_numpy(hists.astype(np.int64)), total)
    np.testing.assert_array_equal(t.numpy(), j)
