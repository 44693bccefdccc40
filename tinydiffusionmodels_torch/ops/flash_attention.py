"""Flash attention: the CUDA kernels' wrappers, their autograd and their build.

Port of the TPU flash-attention kernels of ``tinydiffusionmodels_tpu/ops/
pallas_kernels.py`` to hand-written CUDA C++ for Hopper, built from
``csrc/``:

- ``_flash_kernel`` (forward, with attention-weight dropout) ->
  ``csrc/flash_attention_fwd.cu``;
- ``_flash_dq_kernel`` (recompute backward, dq) ->
  ``csrc/flash_attention_bwd_dq.cu`` (with ``flash_attention_bwd.cuh``, the
  parameters both backward kernels share);
- ``_flash_dkv_kernel`` (recompute backward, dk and dv) ->
  ``csrc/flash_attention_bwd_dkv.cu``;
- ``_dropout_scale`` (the coordinate-hash mask all three share) ->
  ``csrc/dropout_hash.cuh``.

All three run their products on the tensor cores (``csrc/flash_mma.cuh``)
and take every head width Dh and Dv from 1 up (above 256 the D 256
instances walk the width in chunks); the host passes the widest copy the
operands' addresses and strides allow (``vector_bytes``).
The sources' headers say what bounds each kernel on the card and what its
design does about that. The custom
VJPs ``_flash_attention_diffable`` and ``_flash_attention_lse_diffable``
become the ``torch.autograd.Function``s
``_FlashAttention`` (out; ``flash_attention``) and ``_FlashAttentionLse``
((out, lse); ``flash_attention_with_lse``, whose lse gradient folds into
the backward's D term). Both backwards launch the dq and dkv kernels.

Dispatch is on the tensor's device alone, for each kernel: a CPU tensor
goes to its plain PyTorch version (``reference.attention``,
``attention_bwd_dq`` and ``attention_bwd_dkv``), a CUDA tensor launches the
kernel or raises. There is no fallback from one to the other. The autograd
Functions are the same on both devices, and ``work`` gives the bytes and
FLOPs of each kernel's call (``perf``'s bounds and FLOP counts).

The kernels are compiled with ``nvcc`` at first use, from the sources in
``csrc/`` only, by ``ops/_build.py``, which every wrapper shares. Nothing is
built or imported from CUDA when this module is imported.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from tinydiffusionmodels_torch import perf
from tinydiffusionmodels_torch.ops import _build, reference

# Kernel launches made by this process, one counter per kernel: each is
# incremented once per launch of its kernel and nowhere else; callers reset
# them to 0 to count a run.
launches = 0          # forward
dq_launches = 0       # backward, dq
dkv_launches = 0      # backward, dk and dv

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
# ... scale, causal, q_off, k_off, head_off, heads_total, batch_off, seed,
# threshold, keep scale, stream.
_TAIL_ARGTYPES = [ctypes.c_float, _INT, _INT, _INT, _INT, _INT, _INT, _PTR,
                  ctypes.c_uint, ctypes.c_float, _PTR]
_FWD_ARGTYPES = [_PTR] * 5 + [_INT] * 8 + [ctypes.c_longlong] * 12 + \
    _TAIL_ARGTYPES
_BWD_ARGTYPES = [_PTR] * 9 + [_INT] * 8 + \
    [ctypes.POINTER(ctypes.c_longlong)] + _TAIL_ARGTYPES


def _bhl_strides(x: torch.Tensor, layout: str) -> tuple[int, int, int]:
    """Element strides over (batch, head, row) of a 4-D attention operand."""
    s = x.stride()
    return (s[0], s[1], s[2]) if layout == "bhld" else (s[0], s[2], s[1])


def vector_bytes(*operands: torch.Tensor) -> int:
    """The widest copy, in bytes (16, 8, 4 or 2), that every operand's
    rows allow: the largest power of two up to 16 that divides each data
    pointer and each byte stride of a dim longer than 1, the last (the
    contiguous row) aside. The kernels copy rows into shared memory in
    pieces of this size, starting at each row's first element, so a
    strided view (a head of a fused QKV projection) needs no copy of its
    own. bf16 rows on 2-byte boundaries give 2, which
    the kernels load without cp.async."""
    vec = 16
    for x in operands:
        size = x.element_size()
        for value in (x.data_ptr(), *(st * size for st, n in zip(
                x.stride()[:-1], x.shape[:-1]) if n > 1)):
            vec = math.gcd(vec, value)
    return vec


def _dims(q, k, v, layout: str) -> tuple[int, int, int, int, int, int]:
    """(B, H, Lq, Lk, Dh, Dv) of operands in ``layout``."""
    if layout == "bhld":
        b, h, lq, dh = q.shape
    else:
        b, lq, h, dh = q.shape
    return b, h, lq, k.shape[2 if layout == "bhld" else 1], dh, v.shape[-1]


def pairs(b: int, h: int, lq: int, lk: int, *, causal: bool = False,
          q_offset: int = 0, k_offset: int = 0) -> int:
    """(query, key) pairs the kernels compute: every pair, or with
    ``causal`` those where ``q_offset + i >= k_offset + j`` (the kernels
    skip the rest)."""
    if not causal:
        return b * h * lq * lk
    visible = np.clip(q_offset - k_offset + 1 + np.arange(lq), 0, lk)
    return b * h * int(visible.sum())


KERNELS = ("fwd", "dq", "dkv")


def work(kernel: str, q, k, v, *, layout: str = "bhld", causal: bool = False,
         q_offset: int = 0, k_offset: int = 0, dropout_rate: float = 0.0,
         lse: bool = True, **_) -> tuple[int, int]:
    """(bytes, FLOPs) of one call of ``kernel`` ('fwd', 'dq' or 'dkv') on
    these operands, with ``attention``'s keyword arguments: every input read
    once (a tensor passed as more than one of q, k and v counts once; the
    dropout seed 4 bytes), every output written once (``lse=False``: the
    forward's logsumexp is not an output of the call), in the operands'
    dtype and float32 for lse and D; and 2 FLOPs per multiply-add of the
    products the kernel's function needs over ``pairs``: the forward S =
    q k^T and P v; dq S, dP = dO v^T and dS k; dk/dv S, dP, P^T dO and
    dS^T q (P is not an input, so both backward kernels form S)."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown flash kernel {kernel!r}")
    b, h, lq, lk, dh, dv = _dims(q, k, v, layout)
    size = q.element_size()
    operands = {x.data_ptr(): x.numel() for x in (q, k, v)}
    nbytes = size * sum(operands.values()) + (4 if dropout_rate > 0 else 0)
    rows = 4 * b * h * lq                         # lse or D, float32
    n = pairs(b, h, lq, lk, causal=causal, q_offset=q_offset,
              k_offset=k_offset)
    if kernel == "fwd":
        nbytes += size * b * h * lq * dv + (rows if lse else 0)
        return nbytes, 2 * n * (dh + dv)
    nbytes += size * b * h * lq * dv + 2 * rows   # dO; lse and D
    if kernel == "dq":
        return nbytes + size * b * h * lq * dh, 2 * n * (2 * dh + dv)
    return nbytes + size * b * h * lk * (dh + dv), 2 * n * (2 * dh + 2 * dv)


def _check_cuda_operands(q, k, v, layout: str) -> None:
    if layout not in reference.LAYOUTS:
        raise ValueError(f"unknown attention layout: {layout!r}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != q.dtype:
            raise ValueError(f"{name} is {x.dtype}, q is {q.dtype}")
        if x.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got shape {tuple(x.shape)}")
        if x.stride(-1) != 1:
            raise ValueError(
                f"{name} must be contiguous in its last dim, strides "
                f"{x.stride()}"
            )
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"flash attention takes float32 or bfloat16, got {q.dtype}"
        )
    bdim, hdim, ldim = (0, 1, 2) if layout == "bhld" else (0, 2, 1)
    b, h = q.shape[bdim], q.shape[hdim]
    if (k.shape[bdim], k.shape[hdim]) != (b, h) or (
        v.shape[bdim], v.shape[hdim]
    ) != (b, h):
        raise ValueError(
            f"batch/head dims differ: q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)} ({layout})"
        )
    if k.shape[ldim] != v.shape[ldim]:
        raise ValueError("k and v must have the same length")
    if k.shape[-1] != q.shape[-1]:
        raise ValueError("q and k must have the same head dim")
    if min(q.shape[ldim], k.shape[ldim], b, h, q.shape[-1], v.shape[-1]) == 0:
        raise ValueError("flash attention needs non-empty operands")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(
            f"q is on {q.device} but the current CUDA device is "
            f"{torch.cuda.current_device()}"
        )


def _check_seed(seed, q: torch.Tensor) -> None:
    if not (torch.is_tensor(seed) and seed.dtype == torch.int32
            and seed.numel() == 1 and seed.device == q.device):
        raise ValueError(
            "the CUDA kernels read the dropout seed from a one-element int32 "
            f"tensor on {q.device}; got {seed!r}"
        )


def _dropout_args(rate: float, seed, heads: int, head_offset: int,
                  total_heads: int | None, batch_offset: int) -> tuple:
    """(head offset, hashed heads, batch offset, seed pointer or None,
    uint32 threshold, float32 keep scale)."""
    total = heads if total_heads is None else int(total_heads)
    if head_offset < 0 or total < head_offset + heads:
        raise ValueError(f"heads {head_offset}..{head_offset + heads} are "
                         f"not among {total}")
    if batch_offset < 0:
        raise ValueError(f"batch offset {batch_offset} < 0")
    if rate <= 0.0:
        return int(head_offset), total, int(batch_offset), None, 0, 0.0
    return (int(head_offset), total, int(batch_offset), seed.data_ptr(),
            reference.dropout_threshold(rate), 1.0 / (1.0 - rate))


def forward(q, k, v, *, causal, layout, q_offset, k_offset, dropout_rate,
            dropout_seed, head_offset=0, total_heads=None,
            batch_offset=0) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of the forward kernel on checked CUDA operands."""
    global launches
    b, h, lq, lk, dh, dv = _dims(q, k, v, layout)
    out_shape = (b, h, lq, dv) if layout == "bhld" else (b, lq, h, dv)
    out = torch.empty(out_shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    err = _build.function("tdm_flash_attention_fwd", _FWD_ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), _DTYPE_CODES[q.dtype], b, h, lq, lk, dh, dv,
        vector_bytes(q, k, v), *_bhl_strides(q, layout), *_bhl_strides(k, layout),
        *_bhl_strides(v, layout), *_bhl_strides(out, layout),
        1.0 / math.sqrt(dh), int(causal), int(q_offset), int(k_offset),
        *_dropout_args(dropout_rate, dropout_seed, h, head_offset,
                       total_heads, batch_offset),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.raise_on(err, "flash attention forward")
    launches += 1
    return out, lse


def backward_delta(out, g_out, g_lse, layout: str) -> torch.Tensor:
    """D = rowsum(dO * O) - g_lse as contiguous (B, H, Lq) float32 (the TPU
    host leaves this reduction to XLA; here it is one PyTorch expression)."""
    d = (g_out.float() * out.float()).sum(-1)
    if layout == "blhd":
        d = d.transpose(1, 2)
    if g_lse is not None:
        d = d - g_lse
    return d.contiguous()


def _backward_call(name: str, q, k, v, g_out, lse, delta, grads, *, causal,
                   layout, q_offset, k_offset, dropout_rate, dropout_seed,
                   head_offset=0, total_heads=None, batch_offset=0):
    b, h, lq, lk, dh, dv = _dims(q, k, v, layout)
    strides = []
    for x in (q, k, v, g_out, *grads):
        strides.extend(_bhl_strides(x, layout))
    err = _build.function(name, _BWD_ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g_out.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *(g.data_ptr() for g in grads),
        _DTYPE_CODES[q.dtype], b, h, lq, lk, dh, dv,
        vector_bytes(q, k, v, g_out),
        (ctypes.c_longlong * len(strides))(*strides),
        1.0 / math.sqrt(dh), int(causal), int(q_offset), int(k_offset),
        *_dropout_args(dropout_rate, dropout_seed, h, head_offset,
                       total_heads, batch_offset),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.raise_on(err, name)


def backward_dq(q, k, v, g_out, lse, delta, dq, **kw) -> None:
    """One launch of the dq kernel: writes dq (the layout of q)."""
    global dq_launches
    _backward_call("tdm_flash_attention_bwd_dq", q, k, v, g_out, lse, delta,
                   (dq, dq, dq), **kw)
    dq_launches += 1


def backward_dkv(q, k, v, g_out, lse, delta, dk, dv, **kw) -> None:
    """One launch of the dkv kernel: writes dk and dv (the layouts of k, v)."""
    global dkv_launches
    _backward_call("tdm_flash_attention_bwd_dkv", q, k, v, g_out, lse, delta,
                   (dk, dk, dv), **kw)
    dkv_launches += 1


def _forward(q, k, v, dropout_seed, params):
    """(out, lse): the forward kernel on the card, its plain version on the
    CPU (no autograd record)."""
    with perf.kernel_call(lambda: work("fwd", q, k, v, **params)[1]):
        if q.device.type == "cpu":
            with torch.no_grad():
                return reference.attention(q, k, v, dropout_seed=dropout_seed,
                                           **params)
        return forward(q, k, v, dropout_seed=dropout_seed, **params)


def _save(ctx, q, k, v, dropout_seed, params):
    """Forward for an autograd Function; saves its residuals."""
    out, lse = _forward(q, k, v, dropout_seed, params)
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.seed, ctx.params = dropout_seed, params
    ctx.set_materialize_grads(False)
    return out, lse


def _backward(ctx, g_out, g_lse):
    """dq, dk and dv from the dq and dkv kernels (``_flash_bwd_impl``), or
    on the CPU their plain versions; a None cotangent is a zero one."""
    q, k, v, out, lse = ctx.saved_tensors
    params, seed = ctx.params, ctx.seed
    if g_out is None:
        g_out = torch.zeros_like(out)
    elif g_out.dtype != q.dtype or g_out.stride(-1) != 1:
        g_out = g_out.to(q.dtype).contiguous()
    delta = backward_delta(out, g_out, g_lse, params["layout"])
    kw = dict(params, dropout_seed=seed)
    with perf.kernel_call(lambda: sum(work(name, q, k, v, **params)[1]
                                      for name in ("dq", "dkv"))):
        if q.device.type == "cpu":
            dq = reference.attention_bwd_dq(q, k, v, g_out, lse, delta, **kw)
            dk, dv = reference.attention_bwd_dkv(q, k, v, g_out, lse, delta,
                                                 **kw)
            return dq, dk, dv, None, None
        # Gradients take the strides of q, k and v where those are dense,
        # else the contiguous layout of the same logical shape.
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        backward_dq(q, k, v, g_out, lse, delta, dq, **kw)
        backward_dkv(q, k, v, g_out, lse, delta, dk, dv, **kw)
    return dq, dk, dv, None, None


class _FlashAttention(torch.autograd.Function):
    """``_flash_attention_diffable``: out alone, differentiable in q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v, dropout_seed, params):
        return _save(ctx, q, k, v, dropout_seed, params)[0]

    @staticmethod
    def backward(ctx, g_out):
        return _backward(ctx, g_out, None)


class _FlashAttentionLse(torch.autograd.Function):
    """``_flash_attention_lse_diffable``: (out, lse); the lse cotangent folds
    into the backward's D term, D = rowsum(dO * O) - g_lse."""

    @staticmethod
    def forward(ctx, q, k, v, dropout_seed, params):
        return _save(ctx, q, k, v, dropout_seed, params)

    @staticmethod
    def backward(ctx, g_out, g_lse):
        return _backward(ctx, g_out, g_lse)


def _attention(q, k, v, *, with_lse: bool, dropout_seed, **params):
    """Dispatch on the device of q: the plain versions on the CPU, the
    kernels on the card; through the autograd Function when a gradient is
    wanted."""
    if params["dropout_rate"] > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    if q.device.type == "cuda":
        _check_cuda_operands(q, k, v, params["layout"])
        if params["dropout_rate"] > 0.0:
            _check_seed(dropout_seed, q)
        else:
            dropout_seed = None
    elif q.device.type != "cpu":
        raise NotImplementedError(
            f"flash attention has no path for {q.device.type} tensors"
        )
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        fn = _FlashAttentionLse if with_lse else _FlashAttention
        return fn.apply(q, k, v, dropout_seed, params)
    out, lse = _forward(q, k, v, dropout_seed, params)
    return (out, lse) if with_lse else out


def flash_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    layout: str = "bhld",
    q_offset: int = 0,
    k_offset: int = 0,
    dropout_rate: float = 0.0,
    dropout_seed: torch.Tensor | None = None,
    head_offset: int = 0,
    total_heads: int | None = None,
    batch_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Attention and its per-row logsumexp, as ``reference.attention``,
    differentiable in q, k and v through both outputs.

    Returns ``out`` in the layout and dtype of q (width Dv) and ``lse`` as
    (B, H, Lq) float32. CPU tensors run the plain version; CUDA tensors run
    the kernels, which take float32 or bfloat16, every Dh and Dv from 1 up,
    and any strides whose last dim is contiguous. ``dropout_rate`` > 0
    needs ``dropout_seed``: on the card a one-element int32 tensor on the
    same device, which the kernels read there (no host sync); on the CPU
    also an int. ``head_offset`` and ``total_heads`` say which of a layer's
    heads the operands hold (a tensor-parallel rank's slice), and
    ``batch_offset`` which rows of the global batch (a data-parallel
    rank's), so that the dropout mask is that slice of the whole one.
    """
    return _attention(q, k, v, with_lse=True, dropout_seed=dropout_seed,
                      causal=causal, layout=layout, q_offset=int(q_offset),
                      k_offset=int(k_offset), dropout_rate=float(dropout_rate),
                      head_offset=int(head_offset), total_heads=total_heads,
                      batch_offset=int(batch_offset))


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    layout: str = "bhld",
    dropout_rate: float = 0.0,
    dropout_seed: torch.Tensor | None = None,
    head_offset: int = 0,
    total_heads: int | None = None,
    batch_offset: int = 0,
) -> torch.Tensor:
    """``flash_attention_with_lse`` without the logsumexp."""
    return _attention(q, k, v, with_lse=False, dropout_seed=dropout_seed,
                      causal=causal, layout=layout, q_offset=0, k_offset=0,
                      dropout_rate=float(dropout_rate),
                      head_offset=int(head_offset), total_heads=total_heads,
                      batch_offset=int(batch_offset))
