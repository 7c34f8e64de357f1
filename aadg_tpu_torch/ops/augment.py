"""Batched policy augmentation over the 10-op search space.

Port of ``aadg_tpu/ops/augment.py``: the search-space ops (:42-260), the op
table (:391-436), the LUT builders (:464-516), the fused switcher
(:519-622) and the policy appliers (:648-698). Images are (N, H, W, 3) f32
holding exact integers 0..255; every op keeps them integral with PIL's
truncation rules, so the port is bit-exact against the JAX functions.

Where the JAX package vmapped one sample at a time, every function here
takes a batch and per-sample magnitudes. Random choices are split out as
draws (``draw_policy``) so the apply can be fed the numbers JAX drew.

The fused switcher computes each slot's per-channel histograms with K2 and
applies the selected (3, 256) LUT with K3 (``ops/lut.py``). The TPU's
nibble one-hot forms (:83-119) are not carried over.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Tuple

import torch

from . import lut as _lut

# Truncation-boundary epsilon: LUT values are rationals like k*255/d whose
# f32 evaluation can undershoot an exact integer; legitimate fractional
# parts are <= 254/255, so 3e-4 can never flip a true boundary.
_TRUNC_EPS = 3e-4


def _quantize(x: torch.Tensor) -> torch.Tensor:
    """C-style (int) truncation + clip to uint8 range, kept in f32."""
    return torch.clamp(torch.floor(x + _TRUNC_EPS), 0.0, 255.0)


def _luma(img: torch.Tensor) -> torch.Tensor:
    """PIL convert('L'): fixed-point ITU-R 601-2 luma, (..., 3) -> (...)."""
    rgb = img.to(torch.int32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
             + 0x8000) >> 16).float()


def _blend(degenerate, img: torch.Tensor, factor) -> torch.Tensor:
    """PIL Image.blend(degenerate, img, factor) with uint8 truncation."""
    return _quantize(degenerate + factor * (img - degenerate))


def _per_image(v: torch.Tensor) -> torch.Tensor:
    """(N,) -> (N, 1, 1, 1) for broadcasting against (N, H, W, 3)."""
    return v[:, None, None, None]


# ---------------------------------------------------------------------------
# The search-space ops: (img (N,H,W,3), mask (N,H,W), v (N,), centre (N,2))
# ---------------------------------------------------------------------------

def autocontrast(img, mask, v, centre):
    lo = torch.amin(img, dim=(1, 2))[:, None, None, :]
    hi = torch.amax(img, dim=(1, 2))[:, None, None, :]
    scale = 255.0 / torch.clamp(hi - lo, min=1.0)
    out = _quantize((img - lo) * scale)
    return torch.where(hi > lo, out, img), mask


def invert(img, mask, v, centre):
    return 255.0 - img, mask


def equalize_lut(hist: torch.Tensor, total: int) -> torch.Tensor:
    """PIL ImageOps.equalize LUTs from integer histograms (..., 256)
    (``augment.py:122-135``): the step subtracts the count of the last
    *nonzero* bin, and the divisions floor on integers."""
    bins = torch.arange(256, device=hist.device)
    nz = (hist > 0).to(torch.int32)
    idx_last = 255 - torch.argmax(torch.flip(nz, dims=(-1,)), dim=-1)
    last = torch.gather(hist, -1, idx_last[..., None])[..., 0]
    step = (total - last) // 255
    n0 = step // 2
    csum_excl = torch.cumsum(hist, dim=-1) - hist
    lut = torch.clamp((n0[..., None] + csum_excl)
                      // torch.clamp(step, min=1)[..., None], 0, 255)
    return torch.where((step > 0)[..., None], lut, bins)


def equalize(img, mask, v, centre):
    total = img.shape[1] * img.shape[2]
    hist = _lut.hist3(img).long()
    return _lut.lut_apply3(img, equalize_lut(hist, total).float()), mask


def solarize(img, mask, v, centre):
    thresh = _per_image(v)
    return torch.where(img < thresh, img, 255.0 - img), mask


def _posterize_bits(x: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    keep = torch.bitwise_left_shift(torch.full_like(bits, 0xFF), 8 - bits) \
        & 0xFF
    return (x.to(torch.int32) & keep).float()


def posterize(img, mask, v, centre):
    bits = _per_image(torch.floor(v).to(torch.int32))
    return _posterize_bits(img, bits), mask


def _mean_luma(luma: torch.Tensor) -> torch.Tensor:
    """floor(mean + 0.5) of (N, H, W) integer luma; the f32 sum is exact
    (and so equal to JAX's in any order) while H*W*255 < 2^24."""
    total = luma.shape[1] * luma.shape[2]
    return torch.floor(torch.sum(luma, dim=(1, 2)) / total + 0.5)


def contrast(img, mask, v, centre):
    mean = _mean_luma(_luma(img))
    return _blend(_per_image(mean), img, _per_image(v)), mask


def color(img, mask, v, centre):
    return _blend(_luma(img)[..., None], img, _per_image(v)), mask


def brightness(img, mask, v, centre):
    return _blend(0.0, img, _per_image(v)), mask


def sharpness(img, mask, v, centre):
    """Blend with PIL's SMOOTH-filtered image (3x3 [[1,1,1],[1,5,1],[1,1,1]]
    / 13, rounded); the 1-pixel border is copied from the source."""
    n, h, w, c = img.shape
    weights = ((1., 1., 1.), (1., 5., 1.), (1., 1., 1.))
    sm = torch.zeros((n, h - 2, w - 2, c), device=img.device)
    for dy in range(3):
        for dx in range(3):
            sm = sm + weights[dy][dx] * img[:, dy:dy + h - 2, dx:dx + w - 2]
    sm = torch.clamp(torch.floor(sm / 13.0 + 0.5), 0.0, 255.0)
    out = img.clone()
    out[:, 1:-1, 1:-1] = _blend(sm, img[:, 1:-1, 1:-1], _per_image(v))
    return out, mask


def cutout(img, mask, v, centre):
    """v is the fractional size; the (inclusive) box around the drawn
    centre (x0u, y0u) gets (127,127,127) on the image and 0 on the mask."""
    n, h, w, _ = img.shape
    size = v * w
    x0 = torch.floor(torch.clamp(centre[:, 0] - size / 2.0, min=0.0))
    y0 = torch.floor(torch.clamp(centre[:, 1] - size / 2.0, min=0.0))
    x1 = torch.clamp(x0 + size, max=float(w))
    y1 = torch.clamp(y0 + size, max=float(h))
    xs = torch.arange(w, dtype=torch.float32, device=img.device)[None, None]
    ys = torch.arange(h, dtype=torch.float32, device=img.device)[None, :, None]
    inside = ((xs >= x0[:, None, None]) & (xs <= x1[:, None, None])
              & (ys >= y0[:, None, None]) & (ys <= y1[:, None, None])
              & (size > 0.0)[:, None, None])
    img = torch.where(inside[..., None], 127.0, img)
    mask = torch.where(inside, 0.0, mask)
    return img, mask


# (name, fn, low, high) in the order of the reference's augment_list()
OP_TABLE: List[Tuple[str, Callable, float, float]] = [
    ("AutoContrast", autocontrast, 0.0, 1.0),
    ("Invert", invert, 0.0, 1.0),
    ("Equalize", equalize, 0.0, 1.0),
    ("Solarize", solarize, 0.0, 256.0),
    ("Posterize", posterize, 4.0, 8.0),
    ("Contrast", contrast, 0.1, 1.9),
    ("Color", color, 0.1, 1.9),
    ("Brightness", brightness, 0.1, 1.9),
    ("Sharpness", sharpness, 0.1, 1.9),
    ("Cutout", cutout, 0.0, 0.2),
]

OP_NAMES = [t[0] for t in OP_TABLE]
OP_INDEX: Dict[str, int] = {n: i for i, n in enumerate(OP_NAMES)}


def augment_list() -> List[str]:
    """The 10 search-space op names, in the reference's order."""
    return list(OP_NAMES)


# ---------------------------------------------------------------------------
# Fused search-space switcher
# ---------------------------------------------------------------------------

_LUT_OPS = ("AutoContrast", "Invert", "Equalize", "Solarize", "Posterize",
            "Contrast", "Brightness")
_SPECIALS = ("Color", "Sharpness", "Cutout")


def _lut_autocontrast(hist3, total, mean_luma, v, bins):
    idx = torch.arange(256, device=bins.device)
    nz = hist3 > 0
    lo = torch.amin(torch.where(nz, idx, 256), dim=-1).float()
    hi = torch.amax(torch.where(nz, idx, -1), dim=-1).float()
    scale = 255.0 / torch.clamp(hi - lo, min=1.0)
    lut = _quantize((bins - lo[..., None]) * scale[..., None])
    return torch.where((hi > lo)[..., None], lut, bins)


def _lut_invert(hist3, total, mean_luma, v, bins):
    return (255.0 - bins).expand(v.shape[0], 3, 256)


def _lut_equalize(hist3, total, mean_luma, v, bins):
    return equalize_lut(hist3.long(), total).float()


def _lut_solarize(hist3, total, mean_luma, v, bins):
    lut = torch.where(bins < v[:, None], bins, 255.0 - bins)
    return lut[:, None, :].expand(-1, 3, -1)


def _lut_posterize(hist3, total, mean_luma, v, bins):
    lut = _posterize_bits(bins, torch.floor(v).to(torch.int32)[:, None])
    return lut[:, None, :].expand(-1, 3, -1)


def _lut_contrast(hist3, total, mean_luma, v, bins):
    lut = _blend(mean_luma[:, None], bins, v[:, None])
    return lut[:, None, :].expand(-1, 3, -1)


def _lut_brightness(hist3, total, mean_luma, v, bins):
    lut = _blend(0.0, bins, v[:, None])
    return lut[:, None, :].expand(-1, 3, -1)


_LUT_BUILDERS = {
    "AutoContrast": _lut_autocontrast, "Invert": _lut_invert,
    "Equalize": _lut_equalize, "Solarize": _lut_solarize,
    "Posterize": _lut_posterize, "Contrast": _lut_contrast,
    "Brightness": _lut_brightness,
}


def make_fused_op_switcher(op_names: List[str]) -> Callable:
    """Batched LUT-fused switcher over ``op_names`` (a subset of the search
    space): ``switcher(op_idx (N,), level (N,), img, mask, centre (N, 2))``.

    Shared statistics (K2 histograms, luma, its mean) are computed once per
    batch, each LUT op's (N, 3, 256) LUT is built, the per-sample selected
    LUT is applied with K3, and the Color, Sharpness and Cutout candidates
    are selected per sample."""
    unknown = set(op_names) - set(OP_NAMES)
    if unknown:
        raise NotImplementedError(f"ops not ported: {sorted(unknown)}")
    lut_names = [n for n in op_names if n in _LUT_OPS]
    specials = [n for n in _SPECIALS if n in op_names]
    case_of = {n: (1 + specials.index(n) if n in specials else 0)
               for n in op_names}
    need_hist = any(n in ("AutoContrast", "Equalize") for n in lut_names)
    need_luma = any(n in ("Contrast", "Color") for n in op_names)
    need_mean = "Contrast" in lut_names
    # per-op constant tables (lows, highs, case, LUT slot), copied to each
    # device once: a copy per call would stall the host on the stream
    host_tables = (
        torch.tensor([OP_TABLE[OP_INDEX[n]][2] for n in op_names],
                     dtype=torch.float32),
        torch.tensor([OP_TABLE[OP_INDEX[n]][3] for n in op_names],
                     dtype=torch.float32),
        torch.tensor([case_of[x] for x in op_names]),
        torch.tensor([lut_names.index(x) if x in lut_names else 0
                      for x in op_names]),
        torch.arange(256, dtype=torch.float32))
    device_tables = {}

    def switcher(op_idx, level, img, mask, centre):
        dev = img.device
        n, h, w, _ = img.shape
        if dev not in device_tables:
            device_tables[dev] = tuple(t.to(dev) for t in host_tables)
        lo_t, hi_t, case_t, slot_t, bins = device_tables[dev]
        v_all = level[:, None] * (hi_t - lo_t) + lo_t          # (N, K)
        case = case_t[op_idx]

        luma = _luma(img) if need_luma else None
        mean_luma = _mean_luma(luma) if need_mean else None

        out_img, out_mask = img, mask
        if lut_names:
            hist3 = (_lut.hist3(img) if need_hist else None)
            luts = torch.stack([
                _LUT_BUILDERS[x](hist3, h * w, mean_luma,
                                 v_all[:, op_names.index(x)], bins)
                for x in lut_names], dim=1)                     # (N, Kl, 3, 256)
            lut = luts[torch.arange(n, device=dev),
                       slot_t[op_idx]].contiguous()
            out_img = _lut.lut_apply3(img, lut)

        for name in specials:
            v = v_all[:, op_names.index(name)]
            if name == "Color":
                cand = _blend(luma[..., None], img, _per_image(v))
            elif name == "Sharpness":
                cand = sharpness(img, mask, v, centre)[0]
            else:
                cand, cut_m = cutout(img, mask, v, centre)
                out_mask = torch.where(
                    (case == case_of[name])[:, None, None], cut_m, mask)
            out_img = torch.where(
                _per_image(case == case_of[name]), cand, out_img)
        return out_img, out_mask

    return switcher


# ---------------------------------------------------------------------------
# Policy appliers
# ---------------------------------------------------------------------------

class PolicyDraw(NamedTuple):
    q: torch.Tensor        # (N, M) int64 sub-policy index per (sample, policy)
    centre: torch.Tensor   # (N, M, L, 2) f32 Cutout centre (x in [0, W), y in [0, H))


def draw_policy(n: int, m: int, n_subpolicies: int, L: int, h: int, w: int,
                generator: torch.Generator) -> PolicyDraw:
    """The draws of ``augment.py:660`` (sub-policy) and :243-244 (Cutout
    centre) for N samples x M policies."""
    dev = generator.device
    q = torch.randint(0, n_subpolicies, (n, m), generator=generator,
                      device=dev)
    u = torch.rand((n, m, L, 2), generator=generator, device=dev)
    return PolicyDraw(q, torch.stack((u[..., 0] * float(w),
                                      u[..., 1] * float(h)), dim=-1))


def make_policy_applier(op_names: List[str], n_subpolicies: int, L: int,
                        num_mags: int) -> Callable:
    """``apply(imgs, masks, policy (N, Q, L, 2), q (N,), centre (N, L, 2))``:
    sub-policy q of each sample's policy, its L ops in sequence."""
    switcher = make_fused_op_switcher(op_names)

    def apply(imgs, masks, policy, q, centre):
        rows = torch.arange(imgs.shape[0], device=imgs.device)
        chosen = policy[rows, q]                                # (N, L, 2)
        ops = chosen[..., 0]
        mags = chosen[..., 1].float() / (num_mags - 1)
        for l in range(L):
            imgs, masks = switcher(ops[:, l], mags[:, l], imgs, masks,
                                   centre[:, l])
        return imgs, masks

    return apply


def make_multi_policy_applier(op_names: List[str], n_subpolicies: int,
                              L: int, num_mags: int) -> Callable:
    """Batched DGMultiPolicy: ``apply(imgs (N,H,W,3), masks (N,H,W),
    policies (M,Q,L,2), draw) -> (N,M,H,W,3), (N,M,H,W)``; copy (n, m) is
    row n*M + m of the flattened batch."""
    single = make_policy_applier(op_names, n_subpolicies, L, num_mags)

    def apply(imgs, masks, policies, draw: PolicyDraw):
        n, m = imgs.shape[0], policies.shape[0]
        flat_i = imgs[:, None].expand(n, m, *imgs.shape[1:]).reshape(
            n * m, *imgs.shape[1:])
        flat_m = masks[:, None].expand(n, m, *masks.shape[1:]).reshape(
            n * m, *masks.shape[1:])
        pol = policies[None].expand(n, *policies.shape).reshape(
            n * m, *policies.shape[1:])
        out_i, out_m = single(flat_i, flat_m, pol, draw.q.reshape(n * m),
                              draw.centre.reshape(n * m, L, 2))
        return (out_i.reshape(n, m, *imgs.shape[1:]),
                out_m.reshape(n, m, *masks.shape[1:]))

    return apply
