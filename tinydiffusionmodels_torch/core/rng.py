"""The JAX package's PRNG key tree and draws, in PyTorch (port of
``core/rng.py`` and of the parts of ``jax.random`` it uses).

Every random number of the JAX package is a pure function of (seed, the
path of words folded into the key, flat index), through threefry-2x32:

- ``prng_key(seed)`` is ``jax.random.PRNGKey`` (32-bit mode: the key is
  (0, seed mod 2^32));
- ``fold_in(key, w)`` and ``split(key)`` are threefry of the counter pair
  (0, w), and (0, 0) and (0, 1) (the partitionable split);
  ``substream(key, name)`` folds in the name's SHA-1 word, and
  ``key_for_step`` the step;
- ``random_bits`` is the partitionable draw: element i hashes the 64-bit
  counter (i >> 32, i & 0xFFFFFFFF) and keeps ``bits1 ^ bits2``; it
  depends on the flat index alone, so a rank can draw only its slice of
  a global shape (``window``, a box of a larger shape);
- ``uniform``, ``normal`` (through a port of XLA's float32 ``erf_inv``),
  ``randint`` and ``bernoulli`` as ``jax.random`` computes them from those
  bits;
- ``counter_normal`` and ``counter_bernoulli``, the JAX package's
  counter-hash draws (murmur3 fmix32 of the flat index), and
  ``draw_noise`` / ``draw_keep``, which pick them or the stock draws by
  ``TDM_FAST_NOISE`` ('1', '0' or 'auto': the counter draws on a CUDA
  device, the stock draws elsewhere, as the JAX package picks them on
  its accelerator).

These are the plain versions, in torch, on the CPU unless a draw is given
another ``device``. Words are int64 tensors masked to 32 bits (torch's
CPU uint32 has no shift). A key is a
(2,) int64 tensor of its two words. A ``KeyPath`` is a key that is only
known on the device: a base key in a device buffer, then one fold-in of a
device counter (a training step, a sampler's timestep), then fold-ins of
host words. ``ops.rng`` draws from either on the card, in one kernel
launch a draw (``csrc/rng.cu``), and from these functions on the CPU.

The JAX package runs the RBG PRNG on a TPU (``runtime.configure_fast_rng``),
which nothing else reproduces: the port's draws equal the JAX package's
under ``TDM_PRNG=threefry``, and its CUDA draws equal them under
``TDM_FAST_NOISE=1`` too.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import os

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


# ---------------------------------------------------------------------------
# threefry-2x32 and keys
# ---------------------------------------------------------------------------

def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter pair (x0, x1) under the key
    (k0, k1): JAX's ``_threefry2x32_lowering``. Words are Python ints or
    int64 tensors holding 32-bit values; returns the pair in the same
    form."""
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


def key_words(key: torch.Tensor) -> tuple[int, int]:
    """The two words of a (2,) key as Python ints."""
    k0, k1 = (int(w) & M32 for w in key.tolist())
    return k0, k1


def _key(k0: int, k1: int) -> torch.Tensor:
    return torch.tensor([k0, k1], dtype=torch.int64)


def prng_key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` without 64-bit mode: (0, seed mod
    2^32). Seeds outside int64 raise, as JAX's conversion does."""
    seed = int(seed)
    if not -2**63 <= seed < 2**63:
        raise OverflowError(f"seed {seed} does not fit in int64")
    return _key(0, seed & M32)


def _word(data) -> int:
    data = int(data)
    if not -2**31 <= data < 2**32:
        raise OverflowError(f"fold_in data {data} is not a 32-bit word")
    return data & M32


def fold_in(key, data):
    """``jax.random.fold_in``: threefry of (0, data) under the key. ``data``
    is an int, or a one-element integer tensor, whose low 32 bits are
    folded in on the device: the result is then a ``KeyPath``. A key that
    lies on another device than the CPU is never read on the host: its
    fold-ins make a ``KeyPath`` too."""
    if isinstance(key, KeyPath):
        return key.fold_in(data)
    if torch.is_tensor(data):
        return KeyPath(key, counter=data)
    if key.device.type != "cpu":
        return KeyPath(key).fold_in(data)
    k0, k1 = threefry2x32(*key_words(key), 0, _word(data))
    return _key(k0, k1)


def split(key, num: int = 2):
    """``jax.random.split`` in its partitionable form: key i is threefry of
    the counter (0, i), that is ``fold_in(key, i)``."""
    return [fold_in(key, i) for i in range(num)]


def key_for_step(root, step):
    """The key of a global step: ``fold_in(root, step)``."""
    return fold_in(root, step)


def name_word(name: str) -> int:
    """The word ``substream`` folds in: the first 4 bytes of the name's
    SHA-1, little-endian, masked to 31 bits."""
    digest = hashlib.sha1(name.encode("utf-8")).digest()
    return int.from_bytes(digest[:4], "little") & 0x7FFFFFFF


def substream(key, name: str):
    """A named substream of ``key``: ``fold_in(key, name_word(name))``."""
    return fold_in(key, name_word(name))


@dataclasses.dataclass(frozen=True)
class KeyPath:
    """A key derived on the device: ``base`` (a (2,) int64 tensor of key
    words, on the draw's device), then, with ``counter`` (a one-element
    integer tensor on the same device), ``fold_in`` of its low 32 bits,
    then ``fold_in`` of each of ``words``. The draws of ``ops.rng`` derive
    it inside their kernel, so a captured step reads the counter and the
    base where they lie on every replay; on the CPU ``resolve`` computes
    it."""

    base: torch.Tensor
    counter: torch.Tensor | None = None
    words: tuple[int, ...] = ()

    @property
    def device(self) -> torch.device:
        return self.base.device

    def fold_in(self, data) -> "KeyPath":
        if torch.is_tensor(data):
            if self.counter is not None or self.words:
                raise ValueError("a KeyPath folds in one device counter, "
                                 "right after its base key")
            return dataclasses.replace(self, counter=data)
        return dataclasses.replace(self, words=self.words + (_word(data),))

    def resolve(self) -> torch.Tensor:
        """The (2,) key on the CPU (reads the base and counter)."""
        key = self.base.detach().cpu()
        if self.counter is not None:
            key = fold_in(key, int(self.counter.reshape(-1)[0]) & M32)
        for w in self.words:
            key = fold_in(key, w)
        return key


def resolve(key) -> torch.Tensor:
    """A (2,) CPU key from a key or a ``KeyPath``."""
    return key.resolve() if isinstance(key, KeyPath) else key.cpu()


# ---------------------------------------------------------------------------
# The flat indices of a draw
# ---------------------------------------------------------------------------

def _shape(shape) -> tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(d) for d in shape)


def window_of(shape, window=None) -> tuple[tuple[int, int], ...]:
    """``window`` (per dim of ``shape``, (start, size); None: the whole
    dim), checked against ``shape``."""
    shape = _shape(shape)
    if window is None:
        return tuple((0, d) for d in shape)
    if len(window) != len(shape):
        raise ValueError(f"window {window} does not match shape {shape}")
    out = []
    for (start, size), d in zip(window, shape):
        if start < 0 or size < 0 or start + size > d:
            raise ValueError(f"window {window} outside shape {shape}")
        out.append((int(start), int(size)))
    return tuple(out)


def flat_index(shape, window=None, device="cpu") -> torch.Tensor:
    """The global row-major flat indices (int64) of the window's elements,
    in the window's own shape, on ``device``."""
    shape = _shape(shape)
    win = window_of(shape, window)
    idx = torch.zeros((), dtype=torch.int64, device=device)
    stride = 1
    for axis in range(len(shape) - 1, -1, -1):
        start, size = win[axis]
        view = [1] * len(shape)
        view[axis] = size
        idx = idx + (torch.arange(start, start + size, dtype=torch.int64,
                                  device=device) * stride).reshape(view)
        stride *= shape[axis]
    return idx.reshape(tuple(s for _, s in win))


# ---------------------------------------------------------------------------
# The stock draws (jax.random, threefry, partitionable)
# ---------------------------------------------------------------------------

def random_bits(key, shape, window=None, device="cpu") -> torch.Tensor:
    """32-bit random words (int64) of ``shape``: element i (flat) is
    ``bits1 ^ bits2`` of threefry of (i >> 32, i & M32). With ``window``
    the result is that box of ``shape``."""
    k0, k1 = key_words(resolve(key))
    idx = flat_index(shape, window, device)
    b0, b1 = threefry2x32(k0, k1, idx >> 32, idx & M32)
    return b0 ^ b1


def _f32_bits(words: torch.Tensor) -> torch.Tensor:
    return words.to(torch.int32).view(torch.float32)


def _check_f32(dtype) -> None:
    if dtype != torch.float32:
        raise NotImplementedError(f"draws in {dtype}: only float32 is ported")


def uniform(key, shape, dtype=torch.float32, minval=0.0, maxval=1.0,
            window=None, device="cpu") -> torch.Tensor:
    """``jax.random.uniform``: the top 23 bits as a mantissa of [1, 2),
    minus 1, scaled to [minval, maxval) in float32 by one fused
    multiply-add, as XLA computes ``floats * (maxval - minval) + minval``
    (a product and a sum rounded apart differ in about half the elements
    of a span that is not a power of 2)."""
    _check_f32(dtype)
    bits = random_bits(key, shape, window=window, device=device)
    floats = _f32_bits((bits >> 9) | 0x3F800000) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=device)
    return torch.maximum(lo, _fma32(floats, hi - lo, lo))


# XLA's ErfInv32 (Giles, "Approximating the erfinv function"): the w < 5
# and the sqrt(w) - 3 polynomials.
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded once (the product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 erf^-1 as XLA computes it (``lax.erf_inv``): w = -log1p(-x^2),
    then a degree-8 polynomial in w - 2.5 (w < 5) or sqrt(w) - 3, each
    Horner step a fused multiply-add, times x; +-inf at +-1. Within 2 ulp
    of ``jax.random.normal``'s inputs everywhere (``torch.erfinv`` is up to
    65 ulp from it)."""
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


def normal(key, shape, dtype=torch.float32, window=None,
           device="cpu") -> torch.Tensor:
    """``jax.random.normal``: sqrt(2) * erf_inv(u), u uniform on
    [nextafter(-1, 0), 1)."""
    u = uniform(key, shape, dtype, _NORMAL_LO, 1.0, window=window,
                device=device)
    return erf_inv(u) * _SQRT2


_INT_RANGES = {torch.int32: (-2**31, 2**31 - 1),
               torch.int64: (-2**63, 2**63 - 1)}


def randint_params(minval: int, maxval: int, dtype=torch.int32):
    """(clipped minval, span, multiplier) of ``_randint`` for ``dtype``'s
    bit width n: span = maxval - minval as an n-bit word (1 when maxval <=
    minval, one more when maxval is past the type's maximum), multiplier
    = (2^(n/2) mod span)^2 mod span, the square wrapping at n bits as
    ``_randint``'s does."""
    lo, hi = _INT_RANGES[dtype]
    nbits = 32 if dtype == torch.int32 else 64
    mask = (1 << nbits) - 1
    out_of_range = maxval > hi
    minval, maxval = min(max(minval, lo), hi), min(max(maxval, lo), hi)
    span = (maxval - minval) & mask
    if maxval <= minval:
        span = 1
    elif out_of_range:
        span = (span + 1) & mask
    if span == 0:
        # 2^n itself: every remainder below leaves the word unchanged.
        return minval, 0, 0
    multiplier = (1 << (nbits // 2)) % span
    multiplier = ((multiplier * multiplier) & mask) % span   # wraps
    return minval, span, multiplier


def randint(key, shape, minval: int, maxval: int, dtype=torch.int32,
            window=None, device="cpu") -> torch.Tensor:
    """``jax.random.randint``: two draws of n-bit words from the split
    keys, combined modulo the span (n = 32 for int32, 64 for int64). The
    result is ``dtype``."""
    if dtype not in _INT_RANGES:
        raise TypeError(f"randint takes int32 or int64, got {dtype}")
    minval, span, mult = randint_params(int(minval), int(maxval), dtype)
    k_hi, k_lo = split(resolve(key))
    if dtype == torch.int32:
        hi = random_bits(k_hi, shape, window=window, device=device)
        lo = random_bits(k_lo, shape, window=window, device=device)
        off = lo
        if span:
            # uint32 products wrap: int64 keeps their low 32 bits.
            off = ((((hi % span) * mult) & M32) + lo % span) & M32
            off = off % span
        value = (minval + off) & M32
        return torch.where(value >= 2**31, value - 2**32, value).to(
            torch.int32)
    # 64-bit words: (bits1 << 32) | bits2, in numpy's wrapping uint64.
    hi, lo = (_random_bits64(k, shape, window) for k in (k_hi, k_lo))
    if span == 0:
        off = lo
    else:
        s, m = np.uint64(span), np.uint64(mult)
        with np.errstate(over="ignore"):
            off = ((hi % s) * m + lo % s) % s
    with np.errstate(over="ignore"):
        value = (np.uint64(minval & (2**64 - 1)) + off).view(np.int64)
    return torch.from_numpy(np.ascontiguousarray(value))


def _random_bits64(key, shape, window) -> np.ndarray:
    k0, k1 = key_words(key)
    idx = flat_index(shape, window)
    b0, b1 = threefry2x32(k0, k1, idx >> 32, idx & M32)
    return (b0.numpy().astype(np.uint64) << np.uint64(32)) | \
        b1.numpy().astype(np.uint64)


def bernoulli(key, p: float = 0.5, shape=(), window=None,
              device="cpu") -> torch.Tensor:
    """``jax.random.bernoulli``: uniform (float32) < p."""
    return uniform(key, shape, window=window, device=device) < float(
        np.float32(p))


# ---------------------------------------------------------------------------
# The counter-hash draws
# ---------------------------------------------------------------------------

def _fmix32(h):
    """murmur3's finalizer on 32-bit words (ints or int64 tensors)."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & M32
    return h ^ (h >> 16)


def counter_seeds(key) -> tuple[int, int]:
    """(seed, seed2) of the counter draws: the key's words mixed by fmix32
    (host ints; ``counter_normal`` hashes with both, ``counter_bernoulli``
    salts the first)."""
    k0, k1 = key_words(resolve(key))
    seed = _fmix32(k0 ^ ((k1 + 0x9E3779B9) & M32))
    return seed, _fmix32(seed ^ 0x632BE59B)


def counter_normal(key, shape, dtype=torch.float32, window=None,
                   device="cpu") -> torch.Tensor:
    """The JAX package's ``counter_normal``: Box-Muller on two fmix32
    hashes of the pair index; of n draws the first (n + 1) // 2 are the
    r cos(theta) halves and the rest the r sin(theta) halves."""
    _check_f32(dtype)
    shape = _shape(shape)
    n = math.prod(shape)
    seed, seed2 = counter_seeds(key)
    idx = flat_index(shape, window, device=device)
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


def keep_threshold(keep_prob: float) -> int:
    """``counter_bernoulli``'s uint32 threshold: keep where hash >= it."""
    return min(int((1.0 - keep_prob) * 2**32), 2**32 - 1)


def counter_bernoulli(key, keep_prob: float, shape, window=None,
                      device="cpu") -> torch.Tensor:
    """The JAX package's ``counter_bernoulli``: P(True) = keep_prob, from
    fmix32 of the flat index under the salted counter seed."""
    seed = _fmix32(counter_seeds(key)[0] ^ 0x38D1BB47)
    idx = flat_index(shape, window, device=device)
    h = _fmix32((idx * 0x9E3779B9 + seed) & M32)
    return h >= keep_threshold(keep_prob)


def fast_noise(device) -> bool:
    """``TDM_FAST_NOISE``: '1' or '0', or 'auto' (default): the counter
    draws on a CUDA device, the stock draws elsewhere."""
    mode = os.environ.get("TDM_FAST_NOISE", "auto")
    if mode in ("0", "1"):
        return mode == "1"
    return torch.device(device).type == "cuda"


def draw_noise(key, shape, dtype=torch.float32, window=None,
               device="cpu") -> torch.Tensor:
    """The trainers' noise: ``counter_normal`` or ``normal`` by
    ``fast_noise(device)``."""
    if fast_noise(device):
        return counter_normal(key, shape, dtype, window, device)
    return normal(key, shape, dtype, window, device)


def draw_keep(key, keep_prob: float, shape, window=None,
              device="cpu") -> torch.Tensor:
    """The dropout keep-mask: ``counter_bernoulli`` or ``bernoulli`` by
    ``fast_noise(device)``."""
    if fast_noise(device):
        return counter_bernoulli(key, keep_prob, shape, window, device)
    return bernoulli(key, keep_prob, shape, window, device)
