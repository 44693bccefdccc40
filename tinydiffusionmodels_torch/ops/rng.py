"""The JAX package's random draws on the device: the wrapper of
``csrc/rng.cu``.

Each draw is one launch that derives its key from a path (a base key in
device memory, a device counter, host words: ``core.rng.KeyPath``) and
writes the draw: ``normal``, ``randint``, ``counter_normal``, and the
dropout ``keep`` masks applied to a tensor (``dropout``: out = x / p
where kept, 0 elsewhere, the JAX package's ``torch_init.dropout``; its
backward is the same launch on the gradient). Nothing reads the host, so
a captured step replays its draws with the key and counter it finds in
device memory.

Dispatch is on the device alone: a key (and a tensor) on the card
launches the kernel or raises; on the CPU the plain versions of
``core/rng.py`` run. ``draw_noise`` and ``dropout`` pick the counter-hash
or the stock draws by ``TDM_FAST_NOISE`` (``core.rng.fast_noise``: the
counter draws on the card by default).

A draw of a box of a larger shape (``window``) computes exactly those
elements of the one-device draw: a data-parallel rank's rows, a sequence
shard's positions, a tensor-parallel rank's columns.

The library is built at first use by ``ops/_build.py``; nothing is built
when this module is imported.
"""

from __future__ import annotations

import ctypes
import math

import torch

from tinydiffusionmodels_torch.core import rng
from tinydiffusionmodels_torch.ops import _build

# Kernel launches made by this process (incremented once per launch of
# the draw kernel and nowhere else).
launches = 0

_NORMAL, _RANDINT, _KEEP, _COUNTER_NORMAL, _COUNTER_KEEP = range(5)
_F32, _BF16, _I32, _I64 = range(4)
_X_CODES = {torch.float32: _F32, torch.bfloat16: _BF16}
MAX_WORDS, MAX_DIMS = 8, 4

_PTR = ctypes.c_void_p
_LL = ctypes.c_longlong
_ARGTYPES = [ctypes.c_int, _PTR, _PTR, ctypes.POINTER(ctypes.c_uint),
             ctypes.c_int, ctypes.c_int, ctypes.POINTER(_LL),
             ctypes.POINTER(_LL), ctypes.POINTER(_LL), _LL, _PTR, _PTR,
             ctypes.c_int, ctypes.c_uint, ctypes.c_uint, _LL, ctypes.c_float,
             ctypes.c_float, ctypes.c_uint, _PTR]


def box(shape, window=None) -> list[tuple[int, int, int]]:
    """(size, global stride, start) of each dim of the window, with dims
    of one element dropped and a dim merged into the next inner one where
    that one is whole, so a contiguous slice is one dim."""
    shape = tuple(int(d) for d in shape)
    win = rng.window_of(shape, window)
    strides = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        strides[d] = strides[d + 1] * shape[d + 1]
    dims: list[tuple[int, int, int]] = []   # innermost first
    for d in range(len(shape) - 1, -1, -1):
        start, size = win[d]
        if shape[d] == 1:
            continue
        if dims:
            isize, istride, istart = dims[-1]
            if istart == 0 and isize * istride == strides[d]:
                dims[-1] = (size * isize, istride, start * isize)
                continue
        dims.append((size, strides[d], start))
    return dims[::-1] or [(1, 1, 0)]


def _key_path(key, device) -> tuple[torch.Tensor, torch.Tensor | None,
                                    tuple[int, ...]]:
    if isinstance(key, rng.KeyPath):
        base, counter, words = key.base, key.counter, key.words
    else:
        base, counter, words = key, None, ()
    for name, t in (("key", base), ("counter", counter)):
        if t is None:
            continue
        if t.device != device or t.dtype != torch.int64 or \
                not t.is_contiguous():
            raise ValueError(f"the draw kernel reads the {name} as a "
                             f"contiguous int64 tensor on {device}; got "
                             f"{t.dtype} on {t.device}")
    if base.numel() != 2 or (counter is not None and counter.numel() < 1):
        raise ValueError("a key has two words and a counter one")
    if len(words) > MAX_WORDS:
        raise ValueError(f"a key path folds in at most {MAX_WORDS} words")
    return base, counter, words


def _launch(kind: int, key, shape, window, out: torch.Tensor,
            x: torch.Tensor | None = None, *, code: int = _F32,
            span: int = 0, mult: int = 0, minval: int = 0, p: float = 0.0,
            div: float = 1.0, thresh: int = 0) -> None:
    global launches
    device = out.device
    if device.index != torch.cuda.current_device():
        raise ValueError(f"the draw is on {device} but the current CUDA "
                         f"device is {torch.cuda.current_device()}")
    base, counter, words = _key_path(key, device)
    dims = box(shape, window)
    if len(dims) > MAX_DIMS:
        raise ValueError(f"a window of {len(dims)} strided dims (at most "
                         f"{MAX_DIMS})")
    arr = ctypes.c_longlong * len(dims)
    err = _build.function("tdm_rng_draw", _ARGTYPES)(
        kind, base.data_ptr(),
        None if counter is None else counter.data_ptr(),
        (ctypes.c_uint * max(1, len(words)))(*words), len(words), len(dims),
        arr(*(d[0] for d in dims)), arr(*(d[1] for d in dims)),
        arr(*(d[2] for d in dims)), math.prod(int(s) for s in shape),
        out.data_ptr(), None if x is None else x.data_ptr(), code, span,
        mult, minval, p, div, thresh,
        torch.cuda.current_stream(device).cuda_stream)
    _build.raise_on(err, "random draw")
    launches += 1


def _out_shape(shape, window) -> tuple[int, ...]:
    return tuple(size for _, size in rng.window_of(shape, window))


def _device(key) -> torch.device:
    device = key.device
    if device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no random draws on {device.type}")
    return device


def normal(key, shape, *, window=None) -> torch.Tensor:
    """``jax.random.normal`` (float32) on the key's device."""
    device = _device(key)
    if device.type == "cpu":
        return rng.normal(key, shape, window=window)
    out = torch.empty(_out_shape(shape, window), device=device)
    _launch(_NORMAL, key, shape, window, out)
    return out


def counter_normal(key, shape, *, window=None) -> torch.Tensor:
    """The JAX package's ``counter_normal`` (float32) on the key's device."""
    device = _device(key)
    if device.type == "cpu":
        return rng.counter_normal(key, shape, window=window)
    out = torch.empty(_out_shape(shape, window), device=device)
    _launch(_COUNTER_NORMAL, key, shape, window, out)
    return out


def draw_noise(key, shape, *, window=None) -> torch.Tensor:
    """The trainers' noise (``core.rng.draw_noise``) on the key's device."""
    if rng.fast_noise(_device(key)):
        return counter_normal(key, shape, window=window)
    return normal(key, shape, window=window)


def randint(key, shape, minval: int, maxval: int, *, window=None,
            dtype=torch.int64) -> torch.Tensor:
    """``jax.random.randint`` with int32 arithmetic (the JAX package's
    default), returned as ``dtype`` (int32 or int64)."""
    device = _device(key)
    if device.type == "cpu":
        return rng.randint(key, shape, minval, maxval,
                           window=window).to(dtype)
    if dtype not in (torch.int32, torch.int64):
        raise TypeError(f"randint writes int32 or int64, got {dtype}")
    lo, span, mult = rng.randint_params(int(minval), int(maxval))
    out = torch.empty(_out_shape(shape, window), dtype=dtype, device=device)
    _launch(_RANDINT, key, shape, window, out,
            code=_I32 if dtype == torch.int32 else _I64, span=span,
            mult=mult, minval=lo)
    return out


def attention_seed(key) -> torch.Tensor:
    """The flash kernels' dropout seed: ``randint(key, (1,), int32 min,
    int32 max)`` as ``pallas_kernels._pack_scalars`` draws it, a
    one-element int32 tensor on the key's device."""
    return randint(key, (1,), -2**31, 2**31 - 1, dtype=torch.int32)


def _divisor(keep_prob: float, dtype) -> float:
    """The keep probability as the JAX package divides by it: a Python
    float taken into x's dtype."""
    return float(torch.tensor(keep_prob, dtype=dtype).float())


def _mask_launch(x: torch.Tensor, key, keep_prob: float, shape,
                 window) -> torch.Tensor:
    out = torch.empty_like(x)
    div = _divisor(keep_prob, x.dtype)
    if rng.fast_noise(x.device):
        _launch(_COUNTER_KEEP, key, shape, window, out, x,
                code=_X_CODES[x.dtype], div=div,
                thresh=rng.keep_threshold(keep_prob))
    else:
        p = float(torch.tensor(keep_prob, dtype=torch.float32))
        _launch(_KEEP, key, shape, window, out, x, code=_X_CODES[x.dtype],
                p=p, div=div)
    return out


class _Dropout(torch.autograd.Function):
    """Kept elements divided by the keep probability, the rest 0; the
    gradient is the same mask applied to the cotangent (one more launch
    of the same draw)."""

    @staticmethod
    def forward(ctx, x, key, keep_prob, shape, window):
        ctx.args = (key, keep_prob, shape, window)
        return _mask_launch(x, key, keep_prob, shape, window)

    @staticmethod
    def backward(ctx, g):
        return (_mask_launch(g.contiguous(), *ctx.args), None, None, None,
                None)


def dropout(x: torch.Tensor, key, rate: float, *, shape=None,
            window=None) -> torch.Tensor:
    """The JAX package's ``torch_init.dropout``: ``where(keep, x / (1 -
    rate), 0)`` with keep = ``draw_keep(key, 1 - rate, shape)``, ``x`` the
    ``window`` of ``shape`` (default: all of ``x.shape``). None key or rate
    0 returns ``x``. On the card one launch (and one in the backward)."""
    if key is None or rate == 0.0:
        return x
    shape = tuple(x.shape) if shape is None else tuple(shape)
    if _out_shape(shape, window) != tuple(x.shape):
        raise ValueError(f"x {tuple(x.shape)} is not the window {window} "
                         f"of {shape}")
    keep_prob = 1.0 - rate
    if x.device.type == "cpu":
        keep = rng.draw_keep(key, keep_prob, shape, window, device="cpu")
        div = torch.tensor(keep_prob, dtype=x.dtype)
        return torch.where(keep, x / div, torch.zeros((), dtype=x.dtype))
    if x.device.type != "cuda":
        raise NotImplementedError(f"no dropout on {x.device.type}")
    if x.dtype not in _X_CODES:
        raise TypeError(f"dropout takes float32 or bfloat16, got {x.dtype}")
    return _Dropout.apply(x.contiguous(), key, keep_prob, shape, window)
