"""Flash attention: the CUDA kernels' wrappers, their autograd and their build.

Port of the TPU flash-attention kernels of ``tinydiffusionmodels_tpu/ops/
pallas_kernels.py`` to hand-written CUDA C++ for Hopper, built from
``csrc/``:

- ``_flash_kernel`` (forward, with attention-weight dropout) ->
  ``csrc/flash_attention_fwd.cu``;
- ``_flash_dq_kernel`` and ``_flash_dkv_kernel`` (recompute backward) ->
  ``csrc/flash_attention_bwd.cuh``, built from ``flash_attention_bwd_dq.cu``
  and ``flash_attention_bwd_dkv.cu``;
- ``_dropout_scale`` (the coordinate-hash mask all three share) ->
  ``csrc/dropout_hash.cuh``.

The sources' headers say what bounds each kernel on the card and what its
design does about that. The custom VJPs ``_flash_attention_diffable`` and
``_flash_attention_lse_diffable`` become the ``torch.autograd.Function``s
``_FlashAttention`` (out; ``flash_attention``) and ``_FlashAttentionLse``
((out, lse); ``flash_attention_with_lse``, whose lse gradient folds into
the backward's D term). Both backwards launch the dq and dkv kernels.

Dispatch is on the tensor's device alone. A CPU tensor goes to the plain
PyTorch version (``ops/reference.py``), whose backward is its autograd; a
CUDA tensor launches the kernels or raises. There is no fallback from one to
the other.

The kernels are compiled with ``nvcc`` at first use, from the sources in
``csrc/`` only, by ``ops/_build.py``, which every wrapper shares. Nothing is
built or imported from CUDA when this module is imported.
"""

from __future__ import annotations

import ctypes
import math

import torch

from tinydiffusionmodels_torch.ops import _build, reference

# Kernel launches made by this process, one counter per kernel: each is
# incremented once per launch of its kernel and nowhere else; callers reset
# them to 0 to count a run.
launches = 0          # forward
dq_launches = 0       # backward, dq
dkv_launches = 0      # backward, dk and dv

HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_FWD_ARGTYPES = (
    [_PTR] * 5 + [_INT] * 7 + [ctypes.c_longlong] * 12
    + [ctypes.c_float, _INT, _INT, _INT, _PTR, ctypes.c_uint, ctypes.c_float,
       _PTR]
)
_BWD_ARGTYPES = (
    [_PTR] * 9 + [_INT] * 7 + [ctypes.POINTER(ctypes.c_longlong)]
    + [ctypes.c_float, _INT, _INT, _INT, _PTR, ctypes.c_uint, ctypes.c_float,
       _PTR]
)


def _bhl_strides(x: torch.Tensor, layout: str) -> tuple[int, int, int]:
    """Element strides over (batch, head, row) of a 4-D attention operand."""
    s = x.stride()
    return (s[0], s[1], s[2]) if layout == "bhld" else (s[0], s[2], s[1])


def _dims(q, k, v, layout: str) -> tuple[int, int, int, int, int, int]:
    """(B, H, Lq, Lk, Dh, Dv) of operands in ``layout``."""
    if layout == "bhld":
        b, h, lq, dh = q.shape
    else:
        b, lq, h, dh = q.shape
    return b, h, lq, k.shape[2 if layout == "bhld" else 1], dh, v.shape[-1]


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
    if q.device.index != torch.cuda.current_device():
        raise ValueError(
            f"q is on {q.device} but the current CUDA device is "
            f"{torch.cuda.current_device()}"
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
    for name, d in (("Dh", q.shape[-1]), ("Dv", v.shape[-1])):
        if d not in HEAD_DIMS:
            raise ValueError(
                f"{name}={d} is not a width the kernel is built for "
                f"{HEAD_DIMS}"
            )
    if min(q.shape[ldim], k.shape[ldim], b, h) == 0:
        raise ValueError("flash attention needs non-empty operands")


def _check_seed(seed, q: torch.Tensor) -> None:
    if not (torch.is_tensor(seed) and seed.dtype == torch.int32
            and seed.numel() == 1 and seed.device == q.device):
        raise ValueError(
            "the CUDA kernels read the dropout seed from a one-element int32 "
            f"tensor on {q.device}; got {seed!r}"
        )


def _dropout_args(rate: float, seed) -> tuple[int | None, int, float]:
    """(seed pointer or None, uint32 threshold, float32 keep scale)."""
    if rate <= 0.0:
        return None, 0, 0.0
    return seed.data_ptr(), reference.dropout_threshold(rate), 1.0 / (1.0 - rate)


def forward(q, k, v, *, causal, layout, q_offset, k_offset, dropout_rate,
            dropout_seed) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of the forward kernel on checked CUDA operands."""
    global launches
    b, h, lq, lk, dh, dv = _dims(q, k, v, layout)
    out_shape = (b, h, lq, dv) if layout == "bhld" else (b, lq, h, dv)
    out = torch.empty(out_shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    err = _build.function("tdm_flash_attention_fwd", _FWD_ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), _DTYPE_CODES[q.dtype], b, h, lq, lk, dh, dv,
        *_bhl_strides(q, layout), *_bhl_strides(k, layout),
        *_bhl_strides(v, layout), *_bhl_strides(out, layout),
        1.0 / math.sqrt(dh), int(causal), int(q_offset), int(k_offset),
        *_dropout_args(dropout_rate, dropout_seed),
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
                   layout, q_offset, k_offset, dropout_rate, dropout_seed):
    b, h, lq, lk, dh, dv = _dims(q, k, v, layout)
    strides = []
    for x in (q, k, v, g_out, *grads):
        strides.extend(_bhl_strides(x, layout))
    err = _build.function(name, _BWD_ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g_out.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *(g.data_ptr() for g in grads),
        _DTYPE_CODES[q.dtype], b, h, lq, lk, dh, dv,
        (ctypes.c_longlong * len(strides))(*strides),
        1.0 / math.sqrt(dh), int(causal), int(q_offset), int(k_offset),
        *_dropout_args(dropout_rate, dropout_seed),
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


def _save(ctx, q, k, v, dropout_seed, params):
    """Forward kernel for an autograd Function; saves its residuals."""
    out, lse = forward(q, k, v, dropout_seed=dropout_seed, **params)
    ctx.save_for_backward(q, k, v, out, lse, dropout_seed)
    ctx.params = params
    ctx.set_materialize_grads(False)
    return out, lse


def _backward(ctx, g_out, g_lse):
    """dq, dk and dv from the dq and dkv kernels (``_flash_bwd_impl``); a
    None cotangent is a zero one."""
    q, k, v, out, lse, seed = ctx.saved_tensors
    params = ctx.params
    if g_out is None:
        g_out = torch.zeros_like(out)
    elif g_out.dtype != q.dtype or g_out.stride(-1) != 1:
        g_out = g_out.to(q.dtype).contiguous()
    delta = backward_delta(out, g_out, g_lse, params["layout"])
    # Gradients take the strides of q, k and v where those are dense, else
    # the contiguous layout of the same logical shape.
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    kw = dict(params, dropout_seed=seed)
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
    """Dispatch on the device of q: the plain version on the CPU, the
    kernels (through the autograd Function when a gradient is wanted) on
    the card."""
    if params["dropout_rate"] > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    if q.device.type == "cpu":
        out, lse = reference.attention(q, k, v, dropout_seed=dropout_seed,
                                       **params)
        return (out, lse) if with_lse else out
    if q.device.type != "cuda":
        raise NotImplementedError(
            f"flash attention has no path for {q.device.type} tensors"
        )
    _check_cuda_operands(q, k, v, params["layout"])
    if params["dropout_rate"] > 0.0:
        _check_seed(dropout_seed, q)
    else:
        dropout_seed = None
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        fn = _FlashAttentionLse if with_lse else _FlashAttention
        return fn.apply(q, k, v, dropout_seed, params)
    out, lse = forward(q, k, v, dropout_seed=dropout_seed, **params)
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
) -> tuple[torch.Tensor, torch.Tensor]:
    """Attention and its per-row logsumexp, as ``reference.attention``,
    differentiable in q, k and v through both outputs.

    Returns ``out`` in the layout and dtype of q (width Dv) and ``lse`` as
    (B, H, Lq) float32. CPU tensors run the plain version; CUDA tensors run
    the kernels, which take float32 or bfloat16, Dh and Dv in {32, 64, 128},
    and any strides whose last dim is contiguous. ``dropout_rate`` > 0
    needs ``dropout_seed``: on the card a one-element int32 tensor on the
    same device, which the kernels read there (no host sync); on the CPU
    also an int.
    """
    return _attention(q, k, v, with_lse=True, dropout_seed=dropout_seed,
                      causal=causal, layout=layout, q_offset=int(q_offset),
                      k_offset=int(k_offset), dropout_rate=float(dropout_rate))


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    layout: str = "bhld",
    dropout_rate: float = 0.0,
    dropout_seed: torch.Tensor | None = None,
) -> torch.Tensor:
    """``flash_attention_with_lse`` without the logsumexp."""
    return _attention(q, k, v, with_lse=False, dropout_seed=dropout_seed,
                      causal=causal, layout=layout, q_offset=0, k_offset=0,
                      dropout_rate=float(dropout_rate))
