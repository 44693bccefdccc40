"""Pure-Python PNG grid writer: the port's own copy of
``tinydiffusionmodels_tpu/io/images.py`` (the same bytes out).

The reference saves sample grids with torchvision's save_image
(src/mnist.py:110-124). Here we encode 8-bit grayscale PNGs with zlib
directly — no torchvision/PIL dependency — and assemble the same
``nrow``-column padded grid layout (torchvision.utils.make_grid defaults:
padding=2, pad_value=0).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def encode_png_gray(img: np.ndarray) -> bytes:
    """Encode a (H, W) uint8 array as a grayscale PNG."""
    if img.ndim != 2 or img.dtype != np.uint8:
        raise ValueError(f"expected (H, W) uint8, got {img.shape} {img.dtype}")
    h, w = img.shape
    raw = b"".join(b"\x00" + img[row].tobytes() for row in range(h))
    header = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)  # 8-bit grayscale
    return (
        b"\x89PNG\r\n\x1a\n"
        + _png_chunk(b"IHDR", header)
        + _png_chunk(b"IDAT", zlib.compress(raw, 9))
        + _png_chunk(b"IEND", b"")
    )


def make_grid(
    images: np.ndarray,
    nrow: int,
    *,
    padding: int = 2,
    pad_value: float = 0.0,
) -> np.ndarray:
    """Tile (N, H, W) float images in [0, 1] into one grid (torchvision
    make_grid layout: nrow images per row, ``padding`` pixels between and
    around)."""
    n, h, w = images.shape
    ncol = (n + nrow - 1) // nrow
    grid = np.full(
        (padding + ncol * (h + padding), padding + nrow * (w + padding)),
        pad_value,
        dtype=np.float32,
    )
    for idx in range(n):
        r, c = divmod(idx, nrow)
        y = padding + r * (h + padding)
        x = padding + c * (w + padding)
        grid[y : y + h, x : x + w] = images[idx]
    return grid


def grid_png(images: np.ndarray, nrow: int) -> bytes:
    """(N, H, W) floats in [0, 1] -> grayscale grid PNG bytes."""
    grid = make_grid(np.asarray(images, dtype=np.float32), nrow)
    return encode_png_gray(
        (np.clip(grid, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    )
