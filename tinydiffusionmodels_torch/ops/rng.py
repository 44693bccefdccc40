"""The JAX package's random draws on the device: the wrapper of
``csrc/rng.cu``.

A draw derives its key from a path (a base key in device memory or on
the host, a device counter, host words: ``core.rng.KeyPath``) and writes
``normal``, ``uniform``, ``randint`` or ``counter_normal`` values, or
applies a dropout ``keep`` mask to a tensor (``dropout``: out = x / p
where kept, 0 elsewhere, the JAX package's ``torch_init.dropout``; its
backward is the same draw on the gradient). ``draw_many`` makes a list of
draws in one launch: a training step's timesteps, noise and attention
seeds, a model's initial weights. Nothing reads the host, so a captured
step replays its draws with the key and counter it finds in device
memory.

Dispatch is on the device alone: a draw on the card launches the kernel
or raises; on the CPU the plain versions of ``core/rng.py`` run.
``draw_noise`` and ``dropout`` pick the counter-hash or the stock draws by
``TDM_FAST_NOISE`` (``core.rng.fast_noise``: the counter draws on the
card by default).

A draw of a box of a larger shape (``window``) computes exactly those
elements of the one-device draw: a data-parallel rank's rows, a sequence
shard's positions, a tensor-parallel rank's columns.

The library is built at first use by ``ops/_build.py``; nothing is built
when this module is imported.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from tinydiffusionmodels_torch.core import rng
from tinydiffusionmodels_torch.ops import _build

# Kernel launches made by this process (incremented once per launch of
# the draw kernel and nowhere else).
launches = 0

(_NORMAL, _RANDINT, _KEEP, _COUNTER_NORMAL, _COUNTER_KEEP, _UNIFORM,
 _KEY) = range(7)
_F32, _BF16, _I32, _I64 = range(4)
_X_CODES = {torch.float32: _F32, torch.bfloat16: _BF16}
MAX_WORDS, MAX_DIMS = 8, 4
_LL4 = ctypes.c_longlong * MAX_DIMS


class _Draw(ctypes.Structure):
    """``csrc/rng.cu``'s ``Draw``, field for field."""

    _fields_ = [("base", ctypes.c_void_p), ("counter", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("x", ctypes.c_void_p),
                ("size", _LL4), ("gstride", _LL4), ("start", _LL4),
                ("n_global", ctypes.c_longlong),
                ("key", ctypes.c_uint * 2),
                ("words", ctypes.c_uint * MAX_WORDS),
                ("kind", ctypes.c_int), ("dtype", ctypes.c_int),
                ("n_words", ctypes.c_int),
                ("span", ctypes.c_uint), ("mult", ctypes.c_uint),
                ("thresh", ctypes.c_uint), ("minval", ctypes.c_int),
                ("p", ctypes.c_float), ("div", ctypes.c_float),
                ("rcp", ctypes.c_float),
                ("lo", ctypes.c_float), ("hi", ctypes.c_float),
                ("scale", ctypes.c_float)]


_ARGTYPES = [ctypes.c_void_p, ctypes.c_int,
             ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]


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


@dataclasses.dataclass(frozen=True)
class Draw:
    """One draw of ``draw_many``: ``kind`` 'normal' (``jax.random.normal``
    times ``scale``), 'uniform' (``jax.random.uniform`` on [minval,
    maxval)), 'randint' (``jax.random.randint`` on [minval, maxval),
    32-bit, written as ``dtype``: int32 or int64), 'counter_normal' or
    'noise' (``draw_noise``: the counter or the stock normals by
    ``TDM_FAST_NOISE`` on the draw's device), from ``key`` (a (2,) key or
    a ``core.rng.KeyPath``), the ``window`` of ``shape``; or 'key', the
    key itself as a (2,) int64 tensor (a ``KeyPath`` derived once, for
    later draws to fold in from; ``shape`` (2,))."""

    kind: str
    key: object
    shape: tuple
    window: tuple | None = None
    minval: float = 0.0
    maxval: float = 1.0
    scale: float = 1.0
    dtype: torch.dtype = torch.float32


_KINDS = {"normal": _NORMAL, "uniform": _UNIFORM, "randint": _RANDINT,
          "counter_normal": _COUNTER_NORMAL, "key": _KEY}


def _kind(draw: Draw, device: torch.device) -> str:
    if draw.kind == "noise":
        return "counter_normal" if rng.fast_noise(device) else "normal"
    if draw.kind not in _KINDS:
        raise ValueError(f"unknown draw kind {draw.kind!r}")
    return draw.kind


def _plain(draw: Draw, device: torch.device) -> torch.Tensor:
    """The draw by ``core/rng.py`` on ``device``."""
    kind, key, shape, win = _kind(draw, device), draw.key, draw.shape, \
        draw.window
    if kind == "normal":
        out = rng.normal(key, shape, window=win, device=device)
        return out if draw.scale == 1.0 else out * draw.scale
    if kind == "uniform":
        return rng.uniform(key, shape, minval=draw.minval,
                           maxval=draw.maxval, window=win, device=device)
    if kind == "randint":
        return rng.randint(key, shape, int(draw.minval), int(draw.maxval),
                           window=win, device=device).to(draw.dtype)
    if kind == "key":
        return rng.resolve(key).to(device)
    return rng.counter_normal(key, shape, window=win, device=device)


def _key_fields(desc: _Draw, key, device: torch.device) -> None:
    """The key path of a descriptor: a base key on ``device`` (a key, or a
    ``KeyPath``'s base and counter), or a CPU key's words by value."""
    if isinstance(key, rng.KeyPath):
        base, counter, words = key.base, key.counter, key.words
    else:
        base, counter, words = key, None, ()
    if base.numel() != 2 or (counter is not None and counter.numel() < 1):
        raise ValueError("a key has two words and a counter one")
    if len(words) > MAX_WORDS:
        raise ValueError(f"a key path folds in at most {MAX_WORDS} words")
    if base.device.type == "cpu" and counter is None:
        desc.key[0], desc.key[1] = rng.key_words(base)
    else:
        for name, t in (("key", base), ("counter", counter)):
            if t is None:
                continue
            if t.device != device or t.dtype != torch.int64 or \
                    not t.is_contiguous():
                raise ValueError(f"the draw kernel reads the {name} as a "
                                 f"contiguous int64 tensor on {device}; got "
                                 f"{t.dtype} on {t.device}")
        desc.base = base.data_ptr()
        desc.counter = None if counter is None else counter.data_ptr()
    desc.n_words = len(words)
    for i, w in enumerate(words):
        desc.words[i] = w


def _descriptor(kind: int, key, shape, window, out: torch.Tensor,
                x: torch.Tensor | None = None, **fields) -> _Draw:
    """The ``Draw`` descriptor of one draw into ``out`` (and from ``x``)."""
    dims = box(shape, window)
    if len(dims) > MAX_DIMS:
        raise ValueError(f"a window of {len(dims)} strided dims (at most "
                         f"{MAX_DIMS})")
    desc = _Draw(kind=kind, n_global=math.prod(int(s) for s in shape),
                 out=out.data_ptr(), x=None if x is None else x.data_ptr(),
                 scale=1.0, **fields)
    _key_fields(desc, key, out.device)
    # Right-aligned: the outer dims the box does not use are one element.
    for i in range(MAX_DIMS):
        desc.size[i] = 1
    for i, (size, stride, start) in enumerate(dims, MAX_DIMS - len(dims)):
        desc.size[i], desc.gstride[i], desc.start[i] = size, stride, start
    return desc


def _launch(descs: list[_Draw], device: torch.device) -> None:
    """One call of ``tdm_rng_draw_many`` (one launch for every 64 draws),
    counted in ``launches``."""
    global launches
    if device.index != torch.cuda.current_device():
        raise ValueError(f"the draw is on {device} but the current CUDA "
                         f"device is {torch.cuda.current_device()}")
    arr = (_Draw * len(descs))(*descs)
    launched = ctypes.c_int(0)
    err = _build.function("tdm_rng_draw_many", _ARGTYPES)(
        ctypes.addressof(arr), len(descs), ctypes.byref(launched),
        torch.cuda.current_stream(device).cuda_stream)
    _build.raise_on(err, "random draw")
    launches += launched.value


def _out_shape(shape, window) -> tuple[int, ...]:
    return tuple(size for _, size in rng.window_of(shape, window))


def _device(key) -> torch.device:
    device = key.device
    if device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no random draws on {device.type}")
    return device


def draw_many(draws, device=None) -> list[torch.Tensor]:
    """The ``Draw``s on ``device`` (default: the first key's), in one
    kernel launch on the card (one for every 64 draws), by ``core/rng.py``
    on the CPU. Returns their tensors, in the draws' order."""
    draws = list(draws)
    if not draws:
        return []
    device = _device(draws[0].key) if device is None else torch.device(
        device)
    if device.type == "cpu":
        return [_plain(d, device) for d in draws]
    if device.type != "cuda":
        raise NotImplementedError(f"no random draws on {device.type}")
    outs, descs = [], []
    for d in draws:
        kind = _kind(d, device)
        fields = {}
        dtype = torch.float32
        if kind == "randint":
            if d.dtype not in (torch.int32, torch.int64):
                raise TypeError(f"randint writes int32 or int64, got "
                                f"{d.dtype}")
            dtype = d.dtype
            lo, span, mult = rng.randint_params(int(d.minval),
                                                int(d.maxval))
            fields = dict(dtype=_I32 if dtype == torch.int32 else _I64,
                          span=span, mult=mult, minval=lo)
        elif kind == "uniform":
            fields = dict(lo=d.minval, hi=d.maxval)
        elif kind == "key":
            if tuple(d.shape) != (2,) or d.window is not None:
                raise ValueError("a key draw has the shape (2,)")
            dtype, fields = torch.int64, dict(dtype=_I64)
        out = torch.empty(_out_shape(d.shape, d.window), dtype=dtype,
                          device=device)
        desc = _descriptor(_KINDS[kind], d.key, d.shape, d.window, out,
                           **fields)
        if kind == "normal":
            desc.scale = d.scale
        outs.append(out)
        descs.append(desc)
    _launch(descs, device)
    return outs


def _one(draw: Draw) -> torch.Tensor:
    return draw_many([draw])[0]


def normal(key, shape, *, window=None) -> torch.Tensor:
    """``jax.random.normal`` (float32) on the key's device."""
    return _one(Draw("normal", key, tuple(shape), window))


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0, *,
            window=None) -> torch.Tensor:
    """``jax.random.uniform`` (float32) on [minval, maxval), on the key's
    device."""
    return _one(Draw("uniform", key, tuple(shape), window, minval, maxval))


def counter_normal(key, shape, *, window=None) -> torch.Tensor:
    """The JAX package's ``counter_normal`` (float32) on the key's device."""
    return _one(Draw("counter_normal", key, tuple(shape), window))


def draw_noise(key, shape, *, window=None) -> torch.Tensor:
    """The trainers' noise (``core.rng.draw_noise``) on the key's device."""
    return _one(Draw("noise", key, tuple(shape), window))


def randint(key, shape, minval: int, maxval: int, *, window=None,
            dtype=torch.int64) -> torch.Tensor:
    """``jax.random.randint`` with int32 arithmetic (the JAX package's
    default), returned as ``dtype`` (int32 or int64)."""
    return _one(Draw("randint", key, tuple(shape), window, minval, maxval,
                     dtype=dtype))


_SEED_RANGE = (-2**31, 2**31 - 1)


def attention_seed_draw(key) -> Draw:
    """The ``Draw`` of ``attention_seed``, for a list of draws."""
    return Draw("randint", key, (1,), None, *_SEED_RANGE, dtype=torch.int32)


def attention_seed(key) -> torch.Tensor:
    """The flash kernels' dropout seed: ``randint(key, (1,), int32 min,
    int32 max)`` as ``pallas_kernels._pack_scalars`` draws it, a
    one-element int32 tensor on the key's device."""
    return _one(attention_seed_draw(key))


def _divisor(keep_prob: float, dtype) -> float:
    """The keep probability as the JAX package divides by it: a Python
    float taken into x's dtype."""
    return float(torch.tensor(keep_prob, dtype=dtype).float())


def _mask_launch(x: torch.Tensor, key, keep_prob: float, shape,
                 window) -> torch.Tensor:
    out = torch.empty_like(x)
    div = _divisor(keep_prob, x.dtype)
    # The kernel's division by div starts from RN(1 / div), in float32.
    fields = dict(dtype=_X_CODES[x.dtype], div=div,
                  rcp=float(np.float32(1.0) / np.float32(div)))
    if rng.fast_noise(x.device):
        desc = _descriptor(_COUNTER_KEEP, key, shape, window, out, x,
                           thresh=rng.keep_threshold(keep_prob), **fields)
    else:
        desc = _descriptor(_KEEP, key, shape, window, out, x,
                           p=float(np.float32(keep_prob)), **fields)
    _launch([desc], x.device)
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
