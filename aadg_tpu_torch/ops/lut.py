"""K2 and K3: per-channel histogram and LUT apply over a batch of images.

The CUDA kernels (``csrc/hist3.cu``, ``csrc/lut_apply3.cu``) replace the
Pallas kernels ``aadg_tpu/ops/lut_pallas.py::_hist_kernel`` and
``::_apply_kernel``. On the card they are the default path of the fused
augmentation switcher: one launch of each per augmentation slot, over all
N x M images. Both are bound by device-memory bytes.

Each wrapper takes its plain PyTorch version for a CPU tensor only; a CUDA
tensor launches the kernel or raises. ``<wrapper>.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

_MAX_COUNT = 1 << 24  # float counts stay exact below this many pixels


@functools.lru_cache(maxsize=None)
def _hist_fn():
    fn = _build.load("hist3").hist3_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _apply_fn():
    fn = _build.load("lut_apply3").lut_apply3_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_images(img: torch.Tensor) -> None:
    if img.dtype != torch.float32 or img.dim() != 4 or img.shape[-1] != 3:
        raise ValueError(f"expected (N, H, W, 3) float32 images, got "
                         f"{tuple(img.shape)} {img.dtype}")
    if img.shape[0] > 65535:
        raise ValueError("at most 65535 images per launch")
    if img.shape[1] * img.shape[2] >= _MAX_COUNT:
        raise ValueError("images must have fewer than 2^24 pixels")


def hist3_plain(img: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) f32 exact integers 0..255 -> (N, 3, 256) f32 counts."""
    n = img.shape[0]
    codes = img.clamp(0, 255).long().reshape(n, -1, 3) + torch.arange(
        0, 768, 256, device=img.device)
    codes = codes.reshape(n, -1)
    return torch.zeros((n, 768), dtype=torch.float32,
                       device=img.device).scatter_add_(
        1, codes, torch.ones_like(codes, dtype=torch.float32)).reshape(
            n, 3, 256)


def hist3(img: torch.Tensor) -> torch.Tensor:
    """Per-channel 256-bin histograms of a batch: (N, H, W, 3) f32 ->
    (N, 3, 256) f32 exact counts."""
    _check_images(img)
    if img.device.type == "cpu":
        return hist3_plain(img)
    if img.device.type != "cuda" or not img.is_contiguous():
        raise ValueError("hist3 needs a contiguous CPU or CUDA tensor")
    n = img.shape[0]
    per_image = img[0].numel()
    out = torch.empty((n, 3, 256), dtype=torch.float32, device=img.device)
    chunk = 256 * 64
    _build.check(_hist_fn()(img.data_ptr(), out.data_ptr(), n, per_image,
                            chunk, torch.cuda.current_stream().cuda_stream),
                 "hist3")
    hist3.launches += 1
    return out


hist3.launches = 0


def lut_apply3_plain(img: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """out[n, y, x, c] = luts[n, c, img[n, y, x, c]]."""
    n = img.shape[0]
    idx = img.clamp(0, 255).long()
    rows = torch.arange(n, device=img.device)[:, None, None, None]
    chans = torch.arange(3, device=img.device)[None, None, None, :]
    return luts[rows, chans, idx]


def lut_apply3(img: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """Apply per-image, per-channel LUTs: (N, H, W, 3) f32 exact integers,
    (N, 3, 256) f32 -> (N, H, W, 3) f32."""
    _check_images(img)
    if luts.dtype != torch.float32 or tuple(luts.shape) != (
            img.shape[0], 3, 256):
        raise ValueError(f"expected ({img.shape[0]}, 3, 256) float32 LUTs, "
                         f"got {tuple(luts.shape)} {luts.dtype}")
    if img.device != luts.device:
        raise ValueError("images and LUTs must be on one device")
    if img.device.type == "cpu":
        return lut_apply3_plain(img, luts)
    if (img.device.type != "cuda" or not img.is_contiguous()
            or not luts.is_contiguous()):
        raise ValueError("lut_apply3 needs contiguous CPU or CUDA tensors")
    n = img.shape[0]
    out = torch.empty_like(img)
    _build.check(_apply_fn()(img.data_ptr(), luts.data_ptr(), out.data_ptr(),
                             n, img[0].numel(), 256 * 32,
                             torch.cuda.current_stream().cuda_stream),
                 "lut_apply3")
    lut_apply3.launches += 1
    return out


lut_apply3.launches = 0
