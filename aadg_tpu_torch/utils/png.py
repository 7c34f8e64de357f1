"""Lossless 8-bit PNG files from the standard library (``zlib``,
``struct``): test mode's segmentation maps and augmented images. The JAX
package writes these as JPG through imageio."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(arr: np.ndarray) -> bytes:
    """(H, W) grayscale or (H, W, 3) RGB uint8 -> PNG bytes."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8 or arr.ndim not in (2, 3) or (
            arr.ndim == 3 and arr.shape[2] != 3):
        raise ValueError(f"expected (H, W) or (H, W, 3) uint8, got "
                         f"{arr.shape} {arr.dtype}")
    h, w = arr.shape[:2]
    color_type = 0 if arr.ndim == 2 else 2
    rows = arr.reshape(h, -1)
    # filter type 0 (none) before each row
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path, arr: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(arr))
