"""On-device transforms, batched: scale-crop, normalization, label encoding.

Port of ``aadg_tpu/data/transforms.py:20-139``. Every randomized transform
is split into a *draw* (made with a ``torch.Generator``) and a deterministic
*apply* that takes the draw as tensors, so the apply can be held to the JAX
function given the numbers JAX drew.

``random_scale_crop`` reproduces ``jax.image.scale_and_translate`` with the
linear kernel and antialiasing: per-sample separable (in x out) weight
matrices built as in ``jax._src.image.scale.compute_weight_mat`` (triangle
kernel, kernel scale max(1/scale, 1), column renormalization, zero weight
for samples outside the input), applied with two batched matmuls.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

_F32_EPS = float(torch.finfo(torch.float32).eps)


def normalize_image(img: torch.Tensor) -> torch.Tensor:
    """x / 127.5 - 1 (input f32 in [0, 255])."""
    return img / 127.5 - 1.0


def optic_mask_to_multilabel(mask: torch.Tensor) -> torch.Tensor:
    """Raw gray mask (..., H, W) -> (..., H, W, 2) [cup, disc]:
    > 200 background, 50 < v < 201 disc ring, <= 50 cup (cup within disc)."""
    background = mask > 200.0
    ring = (mask > 50.0) & (mask < 201.0)
    cup = ~(background | ring)
    disc = cup | ring
    return torch.stack([cup, disc], dim=-1).float()


def vessel_mask_to_binary(mask: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., H, W, 1): nonzero -> 1."""
    return (mask != 0.0).float()[..., None]


def roi_to_binary(roi: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., H, W, 1): nonzero -> 1 (GenerateMask)."""
    return (roi != 0.0).float()[..., None]


# ---------------------------------------------------------------------------
# Soft domain label (SoftLable)
# ---------------------------------------------------------------------------

def draw_soft_domain_label(n: int, n_classes: int,
                           generator: torch.Generator) -> torch.Tensor:
    """(n, n_classes) uniforms: column 0 sets the true class's mass,
    column i+1 the share of non-true class i (the last class closes the
    simplex and uses none)."""
    return torch.rand((n, n_classes), generator=generator,
                      device=generator.device)


def soft_domain_label(domain_idx: torch.Tensor, n_classes: int,
                      u: torch.Tensor) -> torch.Tensor:
    """Stochastic soft one-hot (``transforms.py:50-71``), batched over
    rows: the true class gets 0.8 + 0.2*u0, the others split the rest
    sequentially and the last index closes the simplex exactly."""
    a = 0.8 + 0.2 * u[:, 0]
    out = torch.zeros((domain_idx.shape[0], n_classes), dtype=u.dtype,
                      device=u.device)
    out[torch.arange(domain_idx.shape[0], device=u.device), domain_idx] = a
    acc = a
    for i in range(n_classes):
        is_true = domain_idx == i
        if i == n_classes - 1:
            val = 1.0 - acc
        else:
            val = u[:, i + 1] * (1.0 - acc)
        out[:, i] = torch.where(is_true, out[:, i], val)
        acc = torch.where(is_true, acc, acc + val)
    return out


# ---------------------------------------------------------------------------
# Random scale + crop (DGRandomScaleCrop)
# ---------------------------------------------------------------------------

class ScaleCropDraw(NamedTuple):
    sw: torch.Tensor   # (N,) width scale (1.0 where the sample is unscaled)
    sh: torch.Tensor   # (N,) height scale
    ux: torch.Tensor   # (N,) uniform in [0, 1) for the crop's left edge
    uy: torch.Tensor   # (N,) uniform in [0, 1) for the crop's top edge


def draw_scale_crop(n: int, scale_range: Tuple[float, float],
                    generator: torch.Generator,
                    p_noscale: float = 0.2) -> ScaleCropDraw:
    """With prob 1 - p_noscale, independent width/height scales uniform in
    ``scale_range`` (``transforms.py:95-106``)."""
    lo, hi = scale_range
    u = torch.rand((5, n), generator=generator, device=generator.device)
    do_scale = u[0] > p_noscale
    sw = torch.where(do_scale, lo + u[1] * (hi - lo), 1.0)
    sh = torch.where(do_scale, lo + u[2] * (hi - lo), 1.0)
    return ScaleCropDraw(sw, sh, u[3], u[4])


def linear_weight_mat(input_size: int, output_size: int,
                      scale: torch.Tensor,
                      translation: torch.Tensor) -> torch.Tensor:
    """Per-sample (N, input_size, output_size) resampling weights of
    ``jax.image.scale_and_translate(method="linear", antialias=True)``."""
    dev = scale.device
    inv_scale = (1.0 / scale)[:, None]
    kernel_scale = torch.clamp(inv_scale, min=1.0)[:, :, None]
    dt = scale.dtype
    sample_f = ((torch.arange(output_size, dtype=dt, device=dev)
                 + 0.5)[None, :] * inv_scale
                - translation[:, None] * inv_scale - 0.5)        # (N, out)
    src = torch.arange(input_size, dtype=dt, device=dev)
    x = torch.abs(sample_f[:, None, :] - src[None, :, None]) / kernel_scale
    weights = torch.clamp(1.0 - torch.abs(x), min=0.0)           # (N, in, out)
    total = torch.sum(weights, dim=1, keepdim=True)
    weights = torch.where(
        torch.abs(total) > 1000.0 * _F32_EPS,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        0.0)
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    return torch.where(inside[:, None, :], weights, 0.0)


def random_scale_crop(img: torch.Tensor, mask: torch.Tensor,
                      draw: ScaleCropDraw, crop: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, H, W, 3) f32 images, (N, H, W) masks -> (N, crop, crop, 3),
    (N, crop, crop): PIL-truncated scaled size, integer crop offset,
    bilinear+antialias for the image, nearest for the mask
    (``transforms.py:74-124``). Needs min scale * size >= crop
    (``make_train_transform`` checks it)."""
    n, h, w = img.shape[0], img.shape[1], img.shape[2]
    new_w = torch.floor(draw.sw * w)
    new_h = torch.floor(draw.sh * h)
    eff_w = new_w / w
    eff_h = new_h / h
    x1 = torch.floor(draw.ux * (new_w - crop + 1.0))
    y1 = torch.floor(draw.uy * (new_h - crop + 1.0))

    wh = linear_weight_mat(h, crop, eff_h, -y1)                  # (N, H, Y)
    ww = linear_weight_mat(w, crop, eff_w, -x1)                  # (N, W, X)
    c = img.shape[3]
    t = torch.bmm(wh.transpose(1, 2), img.reshape(n, h, w * c))  # (N, Y, W*C)
    t = t.reshape(n, crop, w, c).permute(0, 2, 1, 3).reshape(n, w, crop * c)
    out = torch.bmm(ww.transpose(1, 2), t)                       # (N, X, Y*C)
    img_out = out.reshape(n, crop, crop, c).permute(0, 2, 1, 3).contiguous()

    pos = torch.arange(crop, dtype=draw.ux.dtype, device=img.device)[None, :]
    ix = torch.clamp(torch.floor((pos + x1[:, None] + 0.5) / eff_w[:, None]),
                     0, w - 1).long()
    iy = torch.clamp(torch.floor((pos + y1[:, None] + 0.5) / eff_h[:, None]),
                     0, h - 1).long()
    rows = torch.gather(mask, 1, iy[:, :, None].expand(n, crop, w))
    mask_out = torch.gather(rows, 2, ix[:, None, :].expand(n, crop, crop))
    return img_out, mask_out


def make_train_transform(dataset_name: str, crop: int):
    """Batched (scale-crop -> normalize -> mask encode): optic scales
    [1, 1.5] and the (cup, disc) label, every other task scales [0.5, 2]
    and the binary vessel label. Returns (transform, scale_range) with
    ``transform(imgs, masks, draw) -> (x, y)``; the images must be at least
    ``crop / min(scale_range)`` on each side."""
    optic = dataset_name == "optic"
    scale_range = (1.0, 1.5) if optic else (0.5, 2.0)
    to_label = optic_mask_to_multilabel if optic else vessel_mask_to_binary
    lo = scale_range[0]

    def transform(imgs, masks, draw: ScaleCropDraw):
        h, w = imgs.shape[1], imgs.shape[2]
        if lo * min(h, w) < crop:  # the JAX package's assertion
            raise AssertionError(
                f"scale_range {scale_range} x size {h} < crop {crop}")
        imgs, masks = random_scale_crop(imgs, masks, draw, crop)
        return normalize_image(imgs), to_label(masks)

    return transform, scale_range
