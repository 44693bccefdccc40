"""The fused UNet residual block: its CUDA kernel's wrapper and autograd.

Port of ``fused_resblock`` in ``tinydiffusionmodels_tpu/ops/pallas_kernels.py``:
its kernel ``_resblock_kernel`` becomes the hand-written CUDA C++ kernel
``csrc/fused_resblock.cu`` (its header says what bounds it on the card and
what its design does about that), one launch per block, built by
``ops/_build.py``.

``fused_resblock`` is a ``torch.autograd.Function`` on both devices. Its
forward dispatches on the tensor's device alone: a CUDA tensor launches the
kernel or raises, a CPU tensor runs the plain version
(``reference.fused_resblock``). There is no environment knob and no size
threshold; the JAX package's routing of this op to XLA on the TPU
(``registry._AUTO_TPU``) was a TPU measurement and does not carry over. The
backward is the JAX package's ``_fused_resblock_bwd``: it differentiates the
plain version (recomputed under autograd) for x, every weight and bias and
the time bias. The JAX package has no backward kernel for this block, so
neither has the port. As ``jax.vjp(xla_ref.fused_resblock, ...)``, the
backward computes in the operands' dtype (``reference.resblock_in_dtype``):
bf16 convolutions and bf16 gradients for bf16 operands.

The kernel takes float32 or bfloat16, every tensor argument in x's dtype.
It accumulates in float32; in bfloat16 it rounds h to bfloat16 before the
second conv and writes a bfloat16 output, as the TPU kernel does, and so
does the plain version.
"""

from __future__ import annotations

import ctypes
import math

import torch

from tinydiffusionmodels_torch import perf
from tinydiffusionmodels_torch.ops import _build, reference

# Launches of the kernel made by this process: incremented once per launch
# and nowhere else; callers reset it to 0 to count a run.
launches = 0

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_ARGTYPES = [_PTR] * 9 + [_INT] * 8 + [_PTR]
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The output widths the kernel is instantiated for: the MNIST UNet's.
COUTS = (32, 64)
# Output tile edges, 7 or 14 pixels per CTA (both divide the UNet's 28 and
# 14): 14 where it still gives WIDE_TILE_CTAS CTAs, else 7, which spreads
# small batches over the card. On the H100 (tools/resblock_tile_ab.py, f32
# and bf16, every block at batch 1, 3, 25 and 128), 14 was faster wherever it
# gave 100 or more CTAs (28 x 28 at batch 25 and 128, 14 x 14 at 128) and
# slower wherever it gave 25 or fewer.
TILES = (7, 14)
WIDE_TILE_CTAS = 100


def tile_for(b: int, h: int, w: int) -> int:
    """The output tile edge for a (b, h, w) input."""
    small, wide = TILES
    ctas = b * -(-h // wide) * -(-w // wide)
    return wide if ctas >= WIDE_TILE_CTAS else small


def work(x, w1, b1, w2, b2, time_bias, ws=None, bs=None) -> tuple[int, int]:
    """(bytes, FLOPs) of one call on these arguments: every input read once
    and the output written once, in the inputs' dtype; 2 FLOPs per
    multiply-add of both 3x3 convs and the 1x1 skip."""
    b, h, w, cin = x.shape
    cout = w1.shape[0]
    macs = b * h * w * (9 * cin * cout + 9 * cout * cout
                        + (cin * cout if ws is not None else 0))
    elements = sum(t.numel() for t in (x, w1, b1, w2, b2, time_bias, ws, bs)
                   if t is not None) + b * h * w * cout
    return x.element_size() * elements, 2 * macs


def _check(x, w1, b1, w2, b2, time_bias, ws, bs) -> None:
    """Raise before a launch on what the kernel does not take."""
    tensors = {"x": x, "w1": w1, "b1": b1, "w2": w2, "b2": b2,
               "time_bias": time_bias, "ws": ws, "bs": bs}
    for name, t in tensors.items():
        if t is None:
            continue
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"the fused resblock kernel takes float32 or "
                            f"bfloat16; {name} is {t.dtype}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}: the "
                            f"kernel takes one dtype")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, Cin), got {tuple(x.shape)}")
    b, h, w, cin = x.shape
    cout = w1.shape[0]
    want = {"w1": (cout, cin, 3, 3), "b1": (cout,), "w2": (cout, cout, 3, 3),
            "b2": (cout,), "time_bias": (b, 1, 1, cout)}
    if ws is not None:
        want.update(ws=(cout, cin, 1, 1), bs=(cout,))
    for name, shape in want.items():
        if tensors[name] is None or tuple(tensors[name].shape) != shape:
            got = None if tensors[name] is None else tuple(tensors[name].shape)
            raise ValueError(f"{name} must be {shape}, got {got}")
    if ws is None and (bs is not None or cin != cout):
        raise ValueError("the identity skip (ws=None) needs Cin == Cout and "
                         "no bs")
    if cout not in COUTS:
        raise ValueError(f"Cout={cout}: the kernel is built for Cout in "
                         f"{COUTS}")
    if min(b, h, w) == 0:
        raise ValueError("the fused resblock needs a non-empty input")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"x is on {x.device} but the current CUDA device is "
                         f"{torch.cuda.current_device()}")


def _launch(x, w1, b1, w2, b2, time_bias, ws=None, bs=None, *,
            tile: int | None = None) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors; returns (B, H, W, Cout) in
    x's dtype. The weights are packed to (9, Cin, Cout) tap-major copies on
    each call (no cache: in training they change every step). ``tile``
    overrides ``tile_for`` for ``tools/resblock_tile_ab.py``'s
    comparison."""
    global launches
    _check(x, w1, b1, w2, b2, time_bias, ws, bs)
    b, h, w, cin = x.shape
    cout = w1.shape[0]
    x = x.contiguous()
    packed = [w1.permute(2, 3, 1, 0).contiguous(), b1.contiguous(),
              time_bias.reshape(b, cout).contiguous(),
              w2.permute(2, 3, 1, 0).contiguous(), b2.contiguous()]
    if ws is not None:
        packed += [ws.reshape(cout, cin).t().contiguous(), bs.contiguous()]
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    ptrs = [t.data_ptr() for t in packed]
    if ws is None:
        ptrs += [None, None]
    # The widest copy of x's pixel rows into shared memory: every row
    # starts on a multiple of it.
    vec = math.gcd(16, x.data_ptr(), cin * x.element_size())
    err = _build.function("tdm_fused_resblock", _ARGTYPES)(
        x.data_ptr(), *ptrs, out.data_ptr(), _DTYPE_CODES[x.dtype], b, h, w,
        cin, cout, int(tile or tile_for(b, h, w)), vec,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.raise_on(err, "fused resblock")
    launches += 1
    return out


def _forward(*args) -> torch.Tensor:
    with perf.kernel_call(lambda: work(*args)[1]):
        if args[0].device.type == "cpu":
            return reference.fused_resblock(*args)
        return _launch(*args)


class _FusedResblock(torch.autograd.Function):
    """``pallas_kernels.fused_resblock``'s custom VJP: the kernel (or, on
    the CPU, the plain version) forward; the backward differentiates the
    block in the operands' dtype, recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, time_bias, ws, bs):
        ctx.save_for_backward(x, w1, b1, w2, b2, time_bias, ws, bs)
        return _forward(x, w1, b1, w2, b2, time_bias, ws, bs)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, need)]
            out = reference.resblock_in_dtype(*leaves)
            wrt = [t for t, n in zip(leaves, need) if n and t is not None]
            grads = iter(torch.autograd.grad(out, wrt, g))
        return tuple(next(grads) if n and t is not None else None
                     for t, n in zip(leaves, need))


def fused_resblock(x, w1, b1, w2, b2, time_bias, ws=None, bs=None):
    """The UNet residual block, ``reference.fused_resblock``'s semantics:
    x (B, H, W, Cin) NHWC, torch OIHW conv weights, ``time_bias``
    (B, 1, 1, Cout), a 1x1 skip (``ws``, ``bs``) or the identity
    (``ws=None``). Differentiable in every tensor argument. On the card one
    kernel launch per call, float32 or bfloat16 (every argument in x's
    dtype), Cout 32 or 64."""
    args = (x, w1, b1, w2, b2, time_bias, ws, bs)
    if x.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(
            f"the fused resblock has no path for {x.device.type} tensors")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in args):
        return _FusedResblock.apply(*args)
    return _forward(*args)
