"""Kernel timing of the port: each kernel beside its plain version.

    python -m tinydiffusionmodels_torch.kernel_bench [resblock|attention|grad|bf16|all]

Port of ``tools/kernel_bench.py``, with its four modes and its shapes:

- ``resblock``: the UNet's four residual blocks at batch 128, the plain
  version (``reference.fused_resblock``, cuDNN convolutions in full f32)
  and the kernel (``ops.fused_resblock``);
- ``attention``: the forward at (B, H, L, Dh) = (8, 4, 64, 64), the text
  sampler's shape, and two long-sequence shapes: the plain version
  (``reference.attention``), the single-block kernel at L <= 128
  (``ops.single_block_attention``) and the flash kernel;
- ``grad``: forward and backward of the sum of the output, the same shapes
  and implementations;
- ``bf16``: bf16 operands at four shapes, the eval forward and training
  (attention-weight dropout 0.1 and the gradient), plain and flash.

The JAX tool's labels map as follows: ``xla`` is ``plain``; ``pallas`` is
``single_block`` for attention and ``kernel`` for the resblock; ``flash``
is ``flash``. One departure: the ``grad`` mode also times ``single_block``
at L <= 128, where the JAX tool times only XLA and flash. Without that line
no entry point of the port would launch the single-block backward kernel.
As in the JAX tool, the attention modes feed one tensor as q, k and v, so
the gradient sums three terms.

Timing is ``perf.device_ms``: ``ITERS`` calls after ``WARMUP``, queued
behind a sleep kernel and timed with CUDA events, the counterpart of the
JAX tool's scan-length delta. Behind the sleep kernel the host's enqueue
cost stays out of the reading, and a CUDA stream memoises nothing, so the
input need not change between calls. Each line gives the time of one call,
its FLOP rate (the JAX tool's FLOP counts) and, on the card, the share of
the card's bound that the time reaches (``perf.bound_ms``: the input read
once and the output written once over the HBM rate, against the FLOPs over
the peak of the operand type, the larger: bf16 at 989 TFLOP/s; f32
attention as 3xTF32 on the tensor cores, three TF32 products at 495 TFLOP/s
for each (``perf.f32_tensor_core_ops``), as the flash kernels run it; the
f32 residual block at the 67 TFLOP/s FP32 rate). Each mode also returns its
lines as ``Row``s.

It runs on ``runtime.device()``: the card unless ``TDM_PLATFORM=cpu``. On
the CPU the times are the host clock's and no bound share is given (nor on
a card whose peaks ``perf`` does not list); without
a GPU and without ``TDM_PLATFORM=cpu`` it exits non-zero.
"""

from __future__ import annotations

import argparse
import math
from dataclasses import dataclass

import torch

from tinydiffusionmodels_torch import perf, runtime
from tinydiffusionmodels_torch.ops import (
    flash_attention,
    reference,
    resblock,
    single_block,
)

MODES = ("resblock", "attention", "grad", "bf16")
# (B, H, W, Cin, Cout): the four UNet blocks at the bench's batch size.
RESBLOCK_SHAPES = ((128, 28, 28, 1, 32), (128, 14, 14, 32, 64),
                   (128, 14, 14, 64, 64), (128, 28, 28, 96, 32))
# (B, H, L, Dh): the text sampler's attention and two long sequences.
ATTENTION_SHAPES = ((8, 4, 64, 64), (8, 4, 512, 64), (2, 4, 2048, 64))
BF16_SHAPES = ((8, 4, 512, 64), (4, 4, 1024, 64), (8, 4, 1024, 64),
               (2, 4, 2048, 64))
SINGLE_BLOCK_MAX_L = 128
DROPOUT = 0.1
ITERS, WARMUP = 100, 10


@dataclass(frozen=True)
class Row:
    """One timed line: ``us`` per call, ``tflops`` achieved, and
    ``bound_share`` = the card's bound over ``us`` (None on the CPU and on a
    card whose peaks ``perf`` does not list)."""

    mode: str
    shape: tuple
    impl: str
    us: float
    tflops: float
    bound_share: float | None


def _time(mode, shape, impl, fn, *, label, nbytes, flops, peak, device,
          iters, warmup, suffix="") -> Row:
    """One line; ``peak`` is the rate the bound takes the FLOPs at: 'f32',
    'bf16', or '3xtf32' (three TF32 products per f32 product)."""
    us = perf.device_ms(fn, iters, warmup, device) * 1e3
    ops = (perf.f32_tensor_core_ops(flops) if peak == "3xtf32"
           else [(flops, peak)])
    bound = perf.bound_ms(nbytes, ops, device)
    share = None if bound is None else bound[0] * 1e3 / us
    row = Row(mode, tuple(shape), impl, us, flops / us / 1e6, share)
    tail = (f"{share:.4f} of bound" if share is not None
            else "host clock" if device.type != "cuda" else "no bound")
    print(f"{label} {impl:12s}{suffix}: {us:8.1f} us "
          f"({row.tflops:6.1f} TFLOP/s), {tail}", flush=True)
    return row


def _randn(shape, device, seed, scale=1.0):
    g = torch.Generator(device=device).manual_seed(seed)
    return scale * torch.randn(shape, generator=g, device=device)


def bench_resblock(shapes=RESBLOCK_SHAPES, *, device=None, iters=ITERS,
                   warmup=WARMUP) -> list[Row]:
    """The residual block, plain and kernel, forward, f32."""
    device = runtime.device() if device is None else torch.device(device)
    rows = []
    for i, (b, h, w, cin, cout) in enumerate(shapes):
        args = [_randn((b, h, w, cin), device, 10 * i),
                _randn((cout, cin, 3, 3), device, 10 * i + 1,
                       1 / math.sqrt(9 * cin)),
                _randn((cout,), device, 10 * i + 2, 0.1),
                _randn((cout, cout, 3, 3), device, 10 * i + 3,
                       1 / math.sqrt(9 * cout)),
                _randn((cout,), device, 10 * i + 4, 0.1),
                _randn((b, 1, 1, cout), device, 10 * i + 5)]
        if cin != cout:
            args += [_randn((cout, cin, 1, 1), device, 10 * i + 6,
                            1 / math.sqrt(cin)),
                     _randn((cout,), device, 10 * i + 7, 0.1)]
        else:
            args += [None, None]
        nbytes, flops = resblock.work(*args)
        label = f"resblock B{b} {h}x{w} {cin:3d}->{cout:3d}"
        for impl, fn in (("plain", reference.fused_resblock),
                         ("kernel", resblock.fused_resblock)):
            with torch.no_grad():
                rows.append(_time(
                    "resblock", (b, h, w, cin, cout), impl,
                    lambda fn=fn: fn(*args), label=label, nbytes=nbytes,
                    flops=flops, peak="f32", device=device,
                    iters=iters, warmup=warmup))
    return rows


def _attention_impls(with_single_block: bool, **kw):
    """(label, fn(q, k, v) -> out) of the attention implementations timed;
    ``kw`` goes to the plain version and the flash kernel."""
    impls = [("plain", lambda q, k, v: reference.attention(q, k, v, **kw)[0])]
    if with_single_block:
        impls.append(("single_block", single_block.single_block_attention))
    impls.append(("flash", lambda q, k, v: flash_attention.flash_attention(
        q, k, v, **kw)))
    return impls


def _grad(attn, x):
    """The gradient of sum(attn(x, x, x)) with respect to x."""
    return lambda: torch.autograd.grad(attn(x, x, x).float().sum(), x)


def _bench_attention(shapes, *, device, iters, warmup,
                     with_grad) -> list[Row]:
    device = runtime.device() if device is None else torch.device(device)
    mode = "grad" if with_grad else "attention"
    rows = []
    for b, h, length, dh in shapes:
        x = _randn((b, h, length, dh), device, 1).requires_grad_(with_grad)
        # x read once, the output written once (no logsumexp)
        nbytes, flops = flash_attention.work("fwd", x, x, x, lse=False)
        flops *= 3 if with_grad else 1
        label = (f"{'attn-grad' if with_grad else 'attention'} B{b} H{h} "
                 f"L{length:5d} Dh{dh}")
        for impl, attn in _attention_impls(length <= SINGLE_BLOCK_MAX_L):
            fn = _grad(attn, x) if with_grad else (lambda attn=attn: attn(
                x, x, x))
            with torch.set_grad_enabled(with_grad):
                rows.append(_time(
                    mode, (b, h, length, dh), impl, fn, label=label,
                    nbytes=nbytes, flops=flops, peak="3xtf32",
                    device=device, iters=iters, warmup=warmup))
    return rows


def bench_attention(shapes=ATTENTION_SHAPES, *, device=None, iters=ITERS,
                    warmup=WARMUP) -> list[Row]:
    """Attention forward, f32, q = k = v."""
    return _bench_attention(shapes, device=device, iters=iters,
                            warmup=warmup, with_grad=False)


def bench_attention_grad(shapes=ATTENTION_SHAPES, *, device=None,
                         iters=ITERS, warmup=WARMUP) -> list[Row]:
    """Forward and backward of sum(attention(x, x, x)), f32: the recompute
    backward kernels (single-block at L <= 128, flash dq and dkv)."""
    return _bench_attention(shapes, device=device, iters=iters,
                            warmup=warmup, with_grad=True)


def bench_attention_bf16(shapes=BF16_SHAPES, *, device=None, iters=ITERS,
                         warmup=WARMUP) -> list[Row]:
    """bf16 operands, plain and flash: the eval forward, then training
    (attention-weight dropout DROPOUT and the gradient of the f32 sum)."""
    device = runtime.device() if device is None else torch.device(device)
    seed = torch.tensor([7], dtype=torch.int32, device=device)
    rows = []
    for b, h, length, dh in shapes:
        x = _randn((b, h, length, dh), device, 1).bfloat16().requires_grad_()
        nbytes, flops = flash_attention.work("fwd", x, x, x, lse=False)
        mb = b * h * length * length * 4 / 2**20
        label = f"attn-bf16 B{b} H{h} L{length:5d} ({mb:5.0f}MB f32-scores)"
        common = dict(label=label, nbytes=nbytes, peak="bf16",
                      device=device, iters=iters, warmup=warmup)
        for impl, attn in _attention_impls(False):
            with torch.no_grad():
                rows.append(_time("bf16", (b, h, length, dh), impl,
                                  lambda attn=attn: attn(x, x, x),
                                  flops=flops, suffix=" fwd ", **common))
        for impl, attn in _attention_impls(False, dropout_rate=DROPOUT,
                                           dropout_seed=seed):
            rows.append(_time("bf16", (b, h, length, dh), impl,
                              _grad(attn, x), flops=3 * flops,
                              suffix=" grad", **common))
    return rows


BENCHES = {"resblock": bench_resblock, "attention": bench_attention,
           "grad": bench_attention_grad, "bf16": bench_attention_bf16}


def main(argv=None) -> list[Row]:
    parser = argparse.ArgumentParser(
        description="Time the port's kernels beside their plain versions.")
    parser.add_argument("mode", nargs="?", default="all",
                        choices=(*MODES, "all"))
    args = parser.parse_args(argv)
    try:
        device = runtime.device()
    except RuntimeError as err:
        raise SystemExit(f"kernel_bench: {err}") from None
    label = (perf.card_label() if device.type == "cuda"
             else "cpu (host clock: no device time)")
    print(f"kernel bench on {label}; {ITERS} calls per line after {WARMUP}",
          flush=True)
    rows = []
    for mode in MODES:
        if args.mode in (mode, "all"):
            rows += BENCHES[mode](device=device)
    return rows


if __name__ == "__main__":
    main()
