"""The key tree and the draws the program makes, written out plainly.

A frozen copy of what the measured program draws from a seed, so that the
reference can work every draw out again without reading anything the
program made: threefry-2x32 keys (``PRNGKey``, ``fold_in``, ``split``,
named substreams), the stock draws over a flat index (``uniform``,
``normal`` through XLA's float32 ``erf_inv``, ``randint`` in 32 bits), the
counter-hash draws (``counter_normal``, ``counter_bernoulli``) and the
flash kernels' attention-weight dropout hash.

Words are int64 tensors (or Python ints) masked to 32 bits. Every draw
takes the flat indices it is asked for, so a reference can draw the rows
it checks and no others. Keys are (k0, k1) tuples of Python ints.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, of the counter pair (x0, x1)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & M32
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    """``PRNGKey(seed)`` in 32-bit mode: (0, seed mod 2^32)."""
    return 0, int(seed) & M32


def fold_in(key, data: int) -> tuple[int, int]:
    return threefry2x32(key[0], key[1], 0, int(data) & M32)


def split(key, num: int = 2) -> list[tuple[int, int]]:
    """The partitionable split: key i is ``fold_in(key, i)``."""
    return [fold_in(key, i) for i in range(num)]


def name_word(name: str) -> int:
    digest = hashlib.sha1(name.encode("utf-8")).digest()
    return int.from_bytes(digest[:4], "little") & 0x7FFFFFFF


def substream(key, name: str) -> tuple[int, int]:
    return fold_in(key, name_word(name))


def rows_index(shape, rows, device) -> torch.Tensor:
    """Flat indices of whole rows (first axis) of ``shape``, shaped as
    (len(rows), *shape[1:])."""
    inner = math.prod(shape[1:])
    rows = torch.as_tensor(rows, dtype=torch.int64, device=device)
    idx = rows[:, None] * inner + torch.arange(inner, dtype=torch.int64,
                                               device=device)
    return idx.reshape(len(rows), *shape[1:])


def full_index(shape, device) -> torch.Tensor:
    return torch.arange(math.prod(shape), dtype=torch.int64,
                        device=device).reshape(shape)


# --- stock draws -------------------------------------------------------------

def random_bits(key, idx: torch.Tensor) -> torch.Tensor:
    b0, b1 = threefry2x32(key[0], key[1], idx >> 32, idx & M32)
    return b0 ^ b1


def _fma32(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def uniform(key, idx, minval: float = 0.0, maxval: float = 1.0):
    bits = random_bits(key, idx)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=idx.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=idx.device)
    return torch.maximum(lo, _fma32(floats, hi - lo, lo))


_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ErfInv (Giles' two polynomials, fused multiply-adds)."""
    x = x.float()
    w = -torch.log1p((-(x * x)).double()).float()
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    coef = [torch.where(small, a, b)
            for a, b in zip(_ERFINV_SMALL, _ERFINV_LARGE)]
    p = coef[0].float()
    for c in coef[1:]:
        p = _fma32(p, w, c)
    out = p * x
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max,
                       out)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def normal(key, idx) -> torch.Tensor:
    """``jax.random.normal`` at the flat indices ``idx``."""
    return erf_inv(uniform(key, idx, _NORMAL_LO, 1.0)) * _SQRT2


def randint32(key, idx, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint`` in int32 (a span below 2^32), as int64."""
    lo_i, hi_i = -2**31, 2**31 - 1
    out_of_range = maxval > hi_i
    minval, maxval = min(max(minval, lo_i), hi_i), min(max(maxval, lo_i),
                                                       hi_i)
    span = (maxval - minval) & M32
    if maxval <= minval:
        span = 1
    elif out_of_range:
        span = (span + 1) & M32
    mult = ((1 << 16) % span) ** 2 & M32
    mult %= span
    k_hi, k_lo = split(key)
    hi = random_bits(k_hi, idx)
    lo = random_bits(k_lo, idx)
    off = ((((hi % span) * mult) & M32) + lo % span) & M32
    off = off % span
    value = (minval + off) & M32
    return torch.where(value >= 2**31, value - 2**32, value)


# --- counter-hash draws ------------------------------------------------------

def _fmix32(h):
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & M32
    return h ^ (h >> 16)


def _counter_seeds(key) -> tuple[int, int]:
    seed = _fmix32(key[0] ^ ((key[1] + 0x9E3779B9) & M32))
    return seed, _fmix32(seed ^ 0x632BE59B)


def counter_normal(key, idx, n: int) -> torch.Tensor:
    """Box-Muller on two hashes of the pair index; ``n`` is the whole
    draw's element count (the first half are the cosine halves)."""
    seed, seed2 = _counter_seeds(key)
    half = (n + 1) // 2
    second = idx >= half
    pair = torch.where(second, idx - half, idx)
    h1 = _fmix32((pair * 0x9E3779B9 + seed) & M32)
    h2 = _fmix32((pair * 0x85EBCA6B + seed2) & M32)
    u1 = (h1 >> 8).float() * 2.0**-24 + 2.0**-25
    u2 = (h2 >> 8).float() * 2.0**-24
    r = torch.sqrt(-2.0 * torch.log(u1.double()).float())
    theta = u2 * float(np.float32(2.0 * math.pi))
    trig = torch.where(second, torch.sin(theta.double()),
                       torch.cos(theta.double())).float()
    return r * trig


def counter_keep(key, idx, keep_prob: float) -> torch.Tensor:
    seed = _fmix32(_counter_seeds(key)[0] ^ 0x38D1BB47)
    h = _fmix32((idx * 0x9E3779B9 + seed) & M32)
    return h >= min(int((1.0 - keep_prob) * 2**32), 2**32 - 1)


def attention_keep_scale(seed: int, bh, q_pos, k_pos,
                         rate: float) -> torch.Tensor:
    """The flash kernels' attention-weight dropout: 0 or float32(1 / (1 -
    rate)) from fmix32 of the coordinates (bh = row * heads + head)."""
    h = (q_pos * 0x9E3779B9 + k_pos * 0x85EBCA6B + bh * 0xC2B2AE35
         + (int(seed) & M32)) & M32
    keep = _fmix32(h) >= min(int(rate * 2**32), 2**32 - 1)
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32)
    return torch.where(keep, scale.to(keep.device), 0.0)
