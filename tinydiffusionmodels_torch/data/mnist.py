"""MNIST loading: IDX files from disk, torchvision cache layout, or a
deterministic synthetic fallback.

The port's own copy of ``tinydiffusionmodels_tpu/data/mnist.py``: the same
resolution order, the same synthetic digits and cache file for the same
(n, seed), and the same normalization.

Resolution order (see package docstring for rationale):
1. ``root`` / ``$TDM_MNIST_DIR`` containing the standard IDX files
   (train-images-idx3-ubyte etc., raw or .gz), including torchvision's
   ``MNIST/raw`` cache layout (the reference's ./data dir, src/mnist.py:139).
2. torchvision download when importable and the network allows.
3. Synthetic digits: 28x28 renders of a built-in 5x7 bitmap font with
   deterministic jitter/noise — enough for loss-decreases tests, throughput
   benchmarks, and end-to-end demos. Clearly labeled in the return value.
"""

from __future__ import annotations

import gzip
import os
import struct
from pathlib import Path

import numpy as np

_IDX_FILES = {
    True: ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
    False: ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
}

# 5x7 digit bitmaps (rows of 5 bits, MSB left), a classic LCD-style font.
_FONT = {
    0: ["01110", "10001", "10011", "10101", "11001", "10001", "01110"],
    1: ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],
    2: ["01110", "10001", "00001", "00010", "00100", "01000", "11111"],
    3: ["11111", "00010", "00100", "00010", "00001", "10001", "01110"],
    4: ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],
    5: ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],
    6: ["00110", "01000", "10000", "11110", "10001", "10001", "01110"],
    7: ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],
    8: ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],
    9: ["01110", "10001", "10001", "01111", "00001", "00010", "01100"],
}


def _read_idx(path: Path) -> np.ndarray:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def _find_idx(root: Path, base: str) -> Path | None:
    for candidate in (
        root / base,
        root / f"{base}.gz",
        root / "MNIST" / "raw" / base,
        root / "MNIST" / "raw" / f"{base}.gz",
    ):
        if candidate.exists():
            return candidate
    return None


# Bump whenever _synthetic_mnist's output changes for the same (n, seed),
# so stale disk caches are not silently served.
_SYNTH_RENDERER_VERSION = 1


def _synthetic_mnist(n: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic digit-like images: scaled bitmap font + jitter + noise."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n).astype(np.int64)
    images = np.zeros((n, 28, 28), dtype=np.float32)
    glyphs = {}
    for d, rows in _FONT.items():
        bitmap = np.array(
            [[float(c) for c in row] for row in rows], dtype=np.float32
        )
        # Upsample 5x7 -> 20x21 (x4, x3) for an MNIST-ish stroke size.
        glyphs[d] = np.repeat(np.repeat(bitmap, 3, axis=0), 4, axis=1)
    for i in range(n):
        g = glyphs[int(labels[i])]
        gh, gw = g.shape
        dy = int(rng.integers(0, 28 - gh + 1))
        dx = int(rng.integers(0, 28 - gw + 1))
        intensity = 0.75 + 0.25 * float(rng.random())
        images[i, dy : dy + gh, dx : dx + gw] = g * intensity
        images[i] += 0.05 * rng.standard_normal((28, 28)).astype(np.float32)
    images = np.clip(images, 0.0, 1.0)
    return (images * 255).astype(np.uint8), labels


def load_mnist(
    root: str | os.PathLike = "./data",
    *,
    train: bool = True,
    allow_synthetic: bool = True,
    synthetic_size: int = 60_000,
) -> tuple[np.ndarray, np.ndarray, str]:
    """Return (images uint8 (N, 28, 28), labels int64 (N,), source).

    ``source`` is 'idx', 'torchvision', or 'synthetic'.
    """
    root = Path(os.environ.get("TDM_MNIST_DIR", str(root)))
    img_base, lbl_base = _IDX_FILES[train]

    img_path = _find_idx(root, img_base)
    lbl_path = _find_idx(root, lbl_base)
    if img_path is not None and lbl_path is not None:
        return _read_idx(img_path), _read_idx(lbl_path).astype(np.int64), "idx"

    try:  # torchvision path (requires network on first run)
        from torchvision import datasets  # type: ignore

        ds = datasets.MNIST(str(root), train=train, download=True)
        images = ds.data.numpy().astype(np.uint8)
        labels = ds.targets.numpy().astype(np.int64)
        return images, labels, "torchvision"
    except Exception:
        pass

    if not allow_synthetic:
        raise FileNotFoundError(
            f"MNIST not found under {root} and download unavailable; "
            "set TDM_MNIST_DIR or pass allow_synthetic=True"
        )
    n = synthetic_size if train else synthetic_size // 6
    seed = 0 if train else 1
    # Disk cache: the per-image Python render loop takes minutes for the
    # 60k set on one core; the output is deterministic in (n, seed).
    # v-tag guards against serving stale sets if _synthetic_mnist's
    # renderer ever changes — bump _SYNTH_RENDERER_VERSION with it.
    cache = root / f"synthetic_mnist_v{_SYNTH_RENDERER_VERSION}_{n}_{seed}.npz"
    legacy = root / f"synthetic_mnist_{n}_{seed}.npz"
    if (
        not cache.exists()
        and _SYNTH_RENDERER_VERSION == 1
        and legacy.exists()
    ):
        cache = legacy  # pre-versioning cache; renderer unchanged since
    if cache.exists():
        try:
            z = np.load(cache)
            return z["images"], z["labels"], "synthetic"
        except Exception:
            pass
    images, labels = _synthetic_mnist(n, seed=seed)
    try:
        root.mkdir(parents=True, exist_ok=True)
        tmp = cache.with_suffix(".tmp.npz")
        np.savez_compressed(tmp, images=images, labels=labels)
        os.replace(tmp, cache)
    except Exception:
        pass
    return images, labels, "synthetic"


def normalize_mnist(images: np.ndarray) -> np.ndarray:
    """uint8 (N, 28, 28) -> float32 NHWC in [-1, 1].

    Matches the reference transform Normalize((0.5,), (0.5,)) after ToTensor
    (src/mnist.py:141-144): x/255 * 2 - 1.
    """
    x = images.astype(np.float32) / 255.0
    return ((x - 0.5) / 0.5)[..., None]
