"""Single-block attention: the CUDA kernels' wrapper and autograd.

Port of ``_attention_diffable`` in ``tinydiffusionmodels_tpu/ops/
pallas_kernels.py``: its kernels ``_attention_kernel`` (forward) and
``_attention_bwd_kernel`` (recompute backward) become the hand-written CUDA
C++ kernels of ``csrc/attention_single_block.cu`` (its header says what
bounds them on the card and what the design does about that), one launch
each, built by ``ops/_build.py``. Their plain versions are
``reference.single_block_attention`` and
``reference.single_block_attention_bwd``.

``single_block_attention`` is the ``torch.autograd.Function``
``_SingleBlockAttention`` on both devices. Dispatch is on the tensor's device
alone: on CPU tensors its forward and backward are the plain versions, on
CUDA tensors they launch the two kernels or raise. There is no fallback from
one to the other. The JAX package routes no model path to this pair
(``pallas_kernels.attention`` sends small shapes to XLA and large ones to the
flash kernels), so neither does the port: ``ops.attention`` runs the flash
kernels. ``python -m tinydiffusionmodels_torch.kernel_bench`` runs this pair.

Both kernels run their products on the tensor cores. The forward takes one
CTA per (B*H, 16 query rows). The backward is one launch of one CTA per
(B*H, chunk of 16), which writes dq of the chunk's query rows and dk, dv of
its keys; each CTA recomputes every query row's max, sum and D from full
rows (cheap at L <= 128) rather than reading them from a first launch, so
there is one backward launch and no workspace.

The kernels' domain, checked here before any launch: q, k and v of one
shape (B, H, L, Dh), one dtype (float32 or bfloat16), one device, the last
dim contiguous (any other strides); L from 1 to ``MAX_LEN`` (128), because a
query row's scores over all keys are held at once; Dh from 1 to
``MAX_HEAD_DIM`` (256).
"""

from __future__ import annotations

import ctypes
import math

import torch

from tinydiffusionmodels_torch.ops import _build, flash_attention, reference

# Kernel launches made by this process: each is incremented once per launch
# of its kernel and nowhere else; callers reset them to 0 to count a run.
launches = 0        # forward
bwd_launches = 0    # backward

MAX_LEN = 128
MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
_FWD_ARGTYPES = [_PTR] * 4 + [_INT] * 6 + [_STRIDES, ctypes.c_float, _PTR]
_BWD_ARGTYPES = [_PTR] * 7 + [_INT] * 6 + [_STRIDES, ctypes.c_float, _PTR]


def _check_cuda_operands(q, k, v) -> None:
    """Raise before a launch on what the kernels do not take."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != q.dtype:
            raise ValueError(f"{name} is {x.dtype}, q is {q.dtype}")
        if x.shape != q.shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, q "
                             f"{tuple(q.shape)}: the kernels take q, k, v of "
                             "one (B, H, L, Dh) shape")
        if x.dim() != 4:
            raise ValueError(f"{name} must be (B, H, L, Dh), got shape "
                             f"{tuple(x.shape)}")
        if x.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim, "
                             f"strides {x.stride()}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"single-block attention takes float32 or bfloat16, "
                        f"got {q.dtype}")
    b, h, length, dh = q.shape
    if min(b, h, length) == 0:
        raise ValueError("single-block attention needs non-empty operands")
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"Dh={dh} is outside the kernels' widths 1 to "
                         f"{MAX_HEAD_DIM}")
    if length > MAX_LEN:
        raise ValueError(f"L={length} is above the kernels' limit of "
                         f"{MAX_LEN}: a query row's scores over every key "
                         "are held at once")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"q is on {q.device} but the current CUDA device is "
                         f"{torch.cuda.current_device()}")


def _strides(*tensors: torch.Tensor):
    """The (batch, head, row) element strides of each tensor, as the C
    array the entry points read."""
    flat = [s for x in tensors for s in x.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _args(*operands: torch.Tensor):
    """dtype code, B, H, L, Dh and the bytes per copy the operands allow."""
    b, h, length, dh = operands[0].shape
    return (_DTYPE_CODES[operands[0].dtype], b, h, length, dh,
            flash_attention.vector_bytes(*operands))


def forward(q, k, v) -> torch.Tensor:
    """One launch of the forward kernel on checked CUDA operands."""
    global launches
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    err = _build.function("tdm_attention_single_block_fwd", _FWD_ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *_args(q, k, v),
        _strides(q, k, v, out), 1.0 / math.sqrt(q.shape[-1]),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.raise_on(err, "single-block attention forward")
    launches += 1
    return out


def backward(q, k, v, g) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of the backward kernel on checked CUDA operands and the
    output's cotangent ``g`` (q's dtype and shape, last dim contiguous);
    returns (dq, dk, dv) in q's dtype."""
    global bwd_launches
    dq, dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device)
                  for _ in range(3))
    err = _build.function("tdm_attention_single_block_bwd", _BWD_ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *_args(q, k, v, g),
        _strides(q, k, v, g, dq, dk, dv), 1.0 / math.sqrt(q.shape[-1]),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.raise_on(err, "single-block attention backward")
    bwd_launches += 1
    return dq, dk, dv


class _SingleBlockAttention(torch.autograd.Function):
    """``_attention_diffable``: the forward kernel, and the recompute
    backward kernel from the residuals q, k and v alone (no output, no
    logsumexp); on CPU tensors the plain versions of both."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        if q.device.type == "cpu":
            return reference.single_block_attention(q, k, v)
        return forward(q, k, v)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        if g.dtype != q.dtype or g.stride(-1) != 1:
            g = g.to(q.dtype).contiguous()
        if q.device.type == "cpu":
            return reference.single_block_attention_bwd(q, k, v, g)
        return backward(q, k, v, g)


def single_block_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(Dh)) v over (B, H, L, Dh) tensors, with the TPU
    kernel's rounding (``reference.single_block_attention``), differentiable
    in q, k and v. CPU tensors run the plain versions; CUDA tensors launch
    the kernels within the domain of the module docstring, or raise."""
    if q.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(
            f"single-block attention has no path for {q.device.type} tensors")
    if q.device.type == "cuda":
        _check_cuda_operands(q, k, v)
    return _SingleBlockAttention.apply(q, k, v)
