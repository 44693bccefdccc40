"""The fused UNet residual block: its CUDA kernel's wrapper, plan and
autograd.

Port of ``fused_resblock`` in ``tinydiffusionmodels_tpu/ops/pallas_kernels.py``:
its kernel ``_resblock_kernel`` becomes the hand-written CUDA C++ kernel
``csrc/fused_resblock.cu`` (its header says what bounds it on the card and
what its design does about that), one launch per block, built by
``ops/_build.py``. Like the Pallas kernel it takes any Cin and Cout: the
host plans the kernel's tiles (``plan``) to fit the card's shared memory,
and a width no plan fits is refused before a launch.

``fused_resblock_split`` is the JAX package's concat-free decoder block
(``ops.fused_resblock_split``, ``xla_ref.fused_resblock_split``): the
block on cat(upsample(x_a), x_b) along channels. On the card it is the
same kernel, whose gather reads the two sources (x_a at 1/``upsample_a``
of the resolution) into the rows the concatenated tile would fill, so no
upsampled or concatenated tensor is built and the output is bit-equal to
the launch on the materialised concat.

Both are ``torch.autograd.Function``s on both devices. The forward
dispatches on the tensor's device alone: a CUDA tensor launches the kernel
or raises, a CPU tensor runs the plain version (``reference.fused_resblock``,
``reference.fused_resblock_split``). There is no environment knob and no
size threshold; the JAX package's routing of this op to XLA on the TPU
(``registry._AUTO_TPU``) and its ``TDM_SPLIT_DECODER`` batch threshold were
TPU measurements and do not carry over. The backward is the JAX package's
``_fused_resblock_bwd``: it differentiates the plain version (recomputed
under autograd) for the sources, every weight and bias and the time bias.
The JAX package has no backward kernel for this block, so neither has the
port. As ``jax.vjp(xla_ref.fused_resblock, ...)``, the backward computes in
the operands' dtype (``reference.resblock_in_dtype``): bf16 convolutions
and bf16 gradients for bf16 operands.

The kernel takes float32 or bfloat16, every tensor argument in x's dtype.
It accumulates in float32; in bfloat16 it rounds h to bfloat16 before the
second conv and writes a bfloat16 output, as the TPU kernel does, and so
does the plain version.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch
import torch.nn.functional as F

from tinydiffusionmodels_torch import perf
from tinydiffusionmodels_torch.ops import _build, reference

# Launches of the kernel made by this process: incremented once per launch
# and nowhere else; callers reset it to 0 to count a run.
launches = 0

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_ARGTYPES = ([_PTR] * 10 + [_INT] * 13 + [ctypes.c_longlong, _PTR])
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Output tile edges, 7 or 14 pixels per CTA (both divide the UNet's 28 and
# 14): 14 where it still gives WIDE_TILE_CTAS CTAs, else 7, which spreads
# small batches over the card. On the H100
# (tinydiffusionmodels_torch/resblock_tile_ab.py, f32 and bf16, every block
# at batch 1, 3, 25 and 128), 14 was faster wherever it gave 100 or more
# CTAs (28 x 28 at batch 25 and 128, 14 x 14 at 128) and slower wherever it
# gave 25 or fewer. Wider blocks take the largest edge below the rule's
# whose tiles fit (``plan``).
TILES = (7, 14)
WIDE_TILE_CTAS = 100
# The shared memory a block may opt into on the H100 (and the H200).
SMEM_LIMIT = 232_448
# The kernel's layout (csrc/fused_resblock.cu): weight stages in the ring,
# output columns per warp (Cout is padded to them), the column widths of
# its instances, the k step and row padding of each dtype, and the
# k-chunks the plan tries below one chunk of all the channels.
_STAGES = 3
_WARP_COLS = 32
_INSTANCE_COLS = (256, 128, 64, 32)
_STEP = {torch.float32: 8, torch.bfloat16: 16}
_PAD = {torch.float32: 4, torch.bfloat16: 8}
_CHUNKS = (512, 256, 128, 64, 32, 16, 8)
_INT_MAX = 2**31 - 1


def tile_for(b: int, h: int, w: int) -> int:
    """The output tile edge the plan tries first for a (b, h, w) input."""
    small, wide = TILES
    ctas = b * -(-h // wide) * -(-w // wide)
    return wide if ctas >= WIDE_TILE_CTAS else small


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch's layout: the output tile edge, the k-chunk of channels a
    weight stage holds (and the x tile, when ``x_chunked``), the columns a
    pass computes (``column_groups`` warps' 32 each; the instance's width)
    and the passes over the padded Cout, the CTAs and the dynamic shared
    memory in bytes."""

    tile: int
    kc: int
    x_chunked: bool
    nc: int
    column_groups: int
    column_passes: int
    ctas: int
    smem_bytes: int
    sources: int


def smem_bytes(tile: int, cin_pad: int, cout_pad: int, kc: int,
               x_chunked: bool, nc: int, dtype: torch.dtype) -> int:
    """The kernel's shared memory (``Smem`` in csrc/fused_resblock.cu): the
    x tile with its 2-pixel halo (all cin_pad channels, or kc), the h tile
    with its 1-pixel halo (all cout_pad channels, which conv2 needs whole)
    and the ring of weight stages (kc rows of nc columns), rows padded."""
    pad = _PAD[dtype]
    x = (tile + 4) ** 2 * ((kc if x_chunked else cin_pad) + pad)
    h = (tile + 2) ** 2 * (cout_pad + pad)
    return torch.finfo(dtype).bits // 8 * (x + h + _STAGES * kc * (nc + 8))


def plan(batch: int, h: int, w: int, cin: int, cout: int,
         dtype: torch.dtype, *, sources: int = 1,
         tile: int | None = None) -> Plan:
    """The kernel's plan for a (batch, h, w, cin) input and cout outputs
    from one source or two (``fused_resblock_split``, whose gather fills
    the same rows, so the plan is the same): the first tile edge, from
    ``tile_for``'s down to 1 (or ``tile`` alone), and at it the first of
    x whole with one k-chunk, x whole with smaller k-chunks, x in k-chunks,
    whose shared memory fits SMEM_LIMIT (and whose CTAs the grid holds).
    Raises ValueError, before any launch, where none fits."""
    if dtype not in _STEP:
        raise TypeError(f"the fused resblock kernel takes float32 or "
                        f"bfloat16, not {dtype}")
    if sources not in (1, 2):
        raise ValueError(f"sources must be 1 or 2, got {sources}")
    if min(batch, h, w, cin, cout) <= 0:
        raise ValueError(f"the fused resblock needs positive sizes, got "
                         f"batch {batch}, {h} x {w}, Cin {cin}, Cout {cout}")
    step = _STEP[dtype]
    cin_pad = -(-cin // step) * step
    cout_pad = -(-cout // _WARP_COLS) * _WARP_COLS
    nc = next(n for n in _INSTANCE_COLS if cout_pad % n == 0)
    whole = max(cin_pad, cout_pad)
    chunks = [whole] + [k for k in _CHUNKS if k < whole and k % step == 0]
    first = tile_for(batch, h, w)
    for t in [tile] if tile else range(first, 0, -1):
        ctas = batch * -(-h // t) * -(-w // t)
        if ctas > _INT_MAX:
            continue
        for x_chunked in (False, True):
            for kc in chunks:
                if x_chunked and kc >= cin_pad:
                    continue
                nbytes = smem_bytes(t, cin_pad, cout_pad, kc, x_chunked, nc,
                                    dtype)
                if nbytes <= SMEM_LIMIT:
                    return Plan(t, kc, x_chunked, nc, nc // _WARP_COLS,
                                cout_pad // nc, ctas, nbytes, sources)
    least = smem_bytes(tile or 1, cin_pad, cout_pad, step, True, nc, dtype)
    raise ValueError(
        f"Cin={cin}, Cout={cout} ({str(dtype)[6:]}) at tile "
        f"{tile or 1}: the fused resblock kernel needs {least} bytes of "
        f"shared memory a block, above the H100's limit of {SMEM_LIMIT} "
        f"(its h tile holds all Cout channels of the tile and its halo)")


def work(x, w1, b1, w2, b2, time_bias, ws=None, bs=None, *, x_b=None,
         upsample_a: int = 1) -> tuple[int, int]:
    """(bytes, FLOPs) of one call on these arguments: every input read once
    (both sources, x_a at its own size) and the output written once, in the
    inputs' dtype; 2 FLOPs per multiply-add of both 3x3 convs and the 1x1
    skip."""
    b, h, w = (x if x_b is None else x_b).shape[:3]
    cin = x.shape[-1] + (0 if x_b is None else x_b.shape[-1])
    cout = w1.shape[0]
    macs = b * h * w * (9 * cin * cout + 9 * cout * cout
                        + (cin * cout if ws is not None else 0))
    elements = sum(t.numel() for t in (x, x_b, w1, b1, w2, b2, time_bias, ws,
                                       bs)
                   if t is not None) + b * h * w * cout
    return x.element_size() * elements, 2 * macs


def _input_shape(x, x_b, upsample_a: int) -> tuple[int, int, int, int]:
    """(B, H, W, Cin) of the block's input: x, or cat(upsample(x, up),
    x_b) for two sources; raises on sources that do not line up."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, Cin), got {tuple(x.shape)}")
    if x_b is None:
        if upsample_a != 1:
            raise ValueError("upsample_a is for the first of two sources")
        return tuple(x.shape)
    if x_b.dim() != 4:
        raise ValueError(f"x_b must be (B, H, W, Cb), got "
                         f"{tuple(x_b.shape)}")
    up = upsample_a
    b, h, w, cb = x_b.shape
    if (not isinstance(up, int) or up < 1
            or tuple(x.shape[:3]) != (b, h // up, w // up)
            or h % up or w % up):
        raise ValueError(f"x_a {tuple(x.shape)} upsampled {up}x does not "
                         f"match x_b {tuple(x_b.shape)}")
    return b, h, w, x.shape[-1] + cb


def _check(x, w1, b1, w2, b2, time_bias, ws, bs, x_b=None,
           upsample_a: int = 1) -> Plan:
    """Raise before a launch on what the kernel does not take; return its
    plan."""
    tensors = {"x": x, "x_b": x_b, "w1": w1, "b1": b1, "w2": w2, "b2": b2,
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
    b, h, w, cin = _input_shape(x, x_b, upsample_a)
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
    if min(b, h, w) == 0:
        raise ValueError("the fused resblock needs a non-empty input")
    return plan(b, h, w, cin, cout, x.dtype,
                sources=1 if x_b is None else 2)


def _taps(weight: torch.Tensor, cout_pad: int) -> torch.Tensor:
    """torch's (Cout, Cin, k, k) conv weight as the kernel's tap-major
    (k k, Cin, Cout_pad) copy, zero columns past Cout."""
    cout, cin = weight.shape[:2]
    taps = weight.permute(2, 3, 1, 0).reshape(-1, cin, cout)
    if cout_pad == cout:
        return taps.contiguous()
    return F.pad(taps, (0, cout_pad - cout))


def _kernel_args(x, w1, b1, w2, b2, time_bias, ws=None, bs=None, *,
                 x_b=None, upsample_a: int = 1, tile: int | None = None):
    """(output, the C entry point's arguments but the stream, the tensors
    they point into) of one launch; checks and plans first."""
    p = _check(x, w1, b1, w2, b2, time_bias, ws, bs, x_b, upsample_a)
    b, h, w, cin = _input_shape(x, x_b, upsample_a)
    cout = w1.shape[0]
    if tile is not None and tile != p.tile:
        p = plan(b, h, w, cin, cout, x.dtype, sources=p.sources, tile=tile)
    cout_pad = p.nc * p.column_passes
    x = x.contiguous()
    sources = [x] if x_b is None else [x, x_b.contiguous()]
    packed = [_taps(w1, cout_pad), b1.contiguous(),
              time_bias.reshape(b, cout).contiguous(), _taps(w2, cout_pad),
              b2.contiguous()]
    if ws is not None:
        packed += [_taps(ws, cout_pad), bs.contiguous()]
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    ptrs = [t.data_ptr() for t in packed]
    if ws is None:
        ptrs += [None, None]
    # The widest copy of the sources' pixel rows into shared memory: every
    # row of each starts on a multiple of it.
    size = x.element_size()
    vec = math.gcd(16, *(n for s in sources
                         for n in (s.data_ptr(), s.shape[-1] * size)))
    args = (x.data_ptr(), None if x_b is None else sources[1].data_ptr(),
            *ptrs, out.data_ptr(), _DTYPE_CODES[x.dtype], b, h, w, cin,
            x.shape[-1], upsample_a, cout, p.tile, p.kc, int(p.x_chunked),
            p.nc, vec, p.smem_bytes)
    return out, args, (sources, packed)


def _launch(x, w1, b1, w2, b2, time_bias, ws=None, bs=None, *, x_b=None,
            upsample_a: int = 1, tile: int | None = None) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors; returns (B, H, W, Cout) in
    x's dtype. With ``x_b``, x is x_a and the block's input is
    cat(upsample(x_a, upsample_a), x_b). The weights are packed to
    (9, Cin, Cout_pad) tap-major copies on each call (no cache: in training
    they change every step). ``tile`` overrides the plan's tile edge for
    ``resblock_tile_ab``'s comparison."""
    global launches
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"x is on {x.device} but the current CUDA device is "
                         f"{torch.cuda.current_device()}")
    out, args, _keep = _kernel_args(x, w1, b1, w2, b2, time_bias, ws, bs,
                                    x_b=x_b, upsample_a=upsample_a, tile=tile)
    err = _build.function("tdm_fused_resblock", _ARGTYPES)(
        *args, torch.cuda.current_stream(x.device).cuda_stream)
    _build.raise_on(err, "fused resblock")
    launches += 1
    return out


def _forward(x, x_b, upsample_a, *params) -> torch.Tensor:
    with perf.kernel_call(lambda: work(x, *params, x_b=x_b,
                                       upsample_a=upsample_a)[1]):
        if x.device.type == "cpu":
            if x_b is None:
                return reference.fused_resblock(x, *params)
            return reference.fused_resblock_split(
                x, x_b, *params, upsample_a=upsample_a)
        return _launch(x, *params, x_b=x_b, upsample_a=upsample_a)


class _FusedResblock(torch.autograd.Function):
    """``pallas_kernels.fused_resblock``'s custom VJP: the kernel (or, on
    the CPU, the plain version) forward; the backward differentiates the
    block in the operands' dtype, recomputed from the saved inputs, through
    the upsample and concat of two sources."""

    @staticmethod
    def forward(ctx, x, x_b, w1, b1, w2, b2, time_bias, ws, bs, upsample_a):
        ctx.upsample_a = upsample_a
        ctx.save_for_backward(x, x_b, w1, b1, w2, b2, time_bias, ws, bs)
        return _forward(x, x_b, upsample_a, w1, b1, w2, b2, time_bias, ws, bs)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[:-1]
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, need)]
            x = leaves[0] if leaves[1] is None else reference.concat_sources(
                leaves[0], leaves[1], ctx.upsample_a)
            out = reference.resblock_in_dtype(x, *leaves[2:])
            wrt = [t for t, n in zip(leaves, need) if n and t is not None]
            grads = iter(torch.autograd.grad(out, wrt, g))
        return (*(next(grads) if n and t is not None else None
                  for t, n in zip(leaves, need)), None)


def _apply(x, x_b, upsample_a, params) -> torch.Tensor:
    if x.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(
            f"the fused resblock has no path for {x.device.type} tensors")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, x_b, *params)):
        return _FusedResblock.apply(x, x_b, *params, upsample_a)
    return _forward(x, x_b, upsample_a, *params)


def fused_resblock(x, w1, b1, w2, b2, time_bias, ws=None, bs=None):
    """The UNet residual block, ``reference.fused_resblock``'s semantics:
    x (B, H, W, Cin) NHWC, torch OIHW conv weights, ``time_bias``
    (B, 1, 1, Cout), a 1x1 skip (``ws``, ``bs``) or the identity
    (``ws=None``). Differentiable in every tensor argument. On the card one
    kernel launch per call, float32 or bfloat16 (every argument in x's
    dtype), any Cin and Cout whose plan fits (every width up to 1024)."""
    return _apply(x, None, 1, (w1, b1, w2, b2, time_bias, ws, bs))


def fused_resblock_split(x_a, x_b, w1, b1, w2, b2, time_bias, ws=None,
                         bs=None, *, upsample_a: int = 1):
    """The block on cat(upsample_nearest(x_a, upsample_a), x_b) along
    channels (``reference.fused_resblock_split``'s semantics; the JAX
    package's ``xla_ref.fused_resblock_split`` at ``upsample_a=1``): x_a
    (B, H / up, W / up, Ca), x_b (B, H, W, Cb), the weights of a block
    with Cin = Ca + Cb. Differentiable in every tensor argument. On the
    card one kernel launch that reads both sources where the concatenated
    input would be read: no upsampled or concatenated tensor is built."""
    if x_b is None:
        raise ValueError("fused_resblock_split needs two sources")
    return _apply(x_a, x_b, upsample_a, (w1, b1, w2, b2, time_bias, ws, bs))
