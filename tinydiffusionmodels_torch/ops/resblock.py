"""The fused UNet residual block: its CUDA kernel's wrapper, plan and
autograd.

Port of ``fused_resblock`` in ``tinydiffusionmodels_tpu/ops/pallas_kernels.py``:
its kernel ``_resblock_kernel`` becomes hand-written CUDA C++ in
``csrc/fused_resblock.cu`` (its header says what bounds it on the card and
what its design does about that), one launch per block, built by
``ops/_build.py``: the narrow kernel (mma.sync) at the UNet's blocks, the
wgmma kernel (TMA weight ring, clusters) at every other width. Like the
Pallas kernel it takes any Cin and Cout: the host picks the kernel and
plans its tiles (``plan``) to fit the card's shared memory, and a width no
plan fits is refused before a launch.

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
_NARROW_ARGTYPES = [_PTR] * 10 + [_INT] * 10 + [ctypes.c_longlong, _PTR]
_WGMMA_ARGTYPES = [_PTR] * 10 + [_INT] * 15 + [ctypes.c_longlong, _PTR]
_ATTRS_ARGTYPES = [_INT, _INT, ctypes.c_longlong, _INT, _PTR]
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KERNELS = ("narrow", "wgmma")
# The narrow kernel's output tile edges, 7 or 14 pixels per CTA (both
# divide the UNet's 28 and 14): 14 where it still gives WIDE_TILE_CTAS
# CTAs, else 7, which spreads small batches over the card. On the H100
# (tinydiffusionmodels_torch/resblock_tile_ab.py, f32 and bf16, every block
# at batch 1, 3, 25 and 128), 14 was faster wherever it gave 100 or more
# CTAs (28 x 28 at batch 25 and 128, 14 x 14 at 128) and slower wherever it
# gave 25 or fewer.
TILES = (7, 14)
WIDE_TILE_CTAS = 100
# The shared memory a block may opt into on the H100 (and the H200), and
# its SMs.
SMEM_LIMIT = 232_448
SMS = 132
# The narrow kernel's layout (csrc/fused_resblock.cu): weight stages in
# its ring, the row padding of each dtype, its Cout (one instance each).
_STAGES = 3
_NARROW_COLS = (32, 64)
_STEP = {torch.float32: 8, torch.bfloat16: 16}
_PAD = {torch.float32: 4, torch.bfloat16: 8}
# The wgmma kernel's: the column chunks of its instances, the bytes of K a
# weight stage holds (its swizzle), the weight planes (f32: 3xTF32's big
# and small halves), the 64-row m-tiles a phase may have at each chunk
# width (its accumulators within 128 registers a thread; f32 keeps a
# stage's partial sums beside them), and the layouts the plan tries, in
# order: (x chunked, bytes of K a stage, stages). On the H100 (PERF.md §6;
# resblock_trace, resblock_tile_ab --layouts) a stage costs a few hundred
# cycles beside its products and the ring's depth changed little, so x
# whole comes first, then wider stages.
_WGMMA_COLS = (256, 128, 64, 32)
_PLANES = {torch.float32: 2, torch.bfloat16: 1}
_ACC_SETS = {torch.float32: 2, torch.bfloat16: 1}
_LAYOUTS = tuple((chunked, atom, stages)
                 for chunked in (False, True)
                 for atom in (128, 64, 32)
                 for stages in (4, 3, 2))
# CTAs a cluster that share each weight stage by multicast. The kernel
# takes 1, 2 or 4 (``plan(cluster=...)``); at B 8, 32 x 32, 256 -> 256 on
# the H100 clusters of 2 were 5-7 % slower than 1 and clusters of 4 about
# 2x slower (PERF.md §6): the weights' L2 traffic does not bound the
# kernel, the cluster's lockstep release of each stage costs more.
CLUSTER = 1
_MAX_TILE = 30
_INT_MAX = 2**31 - 1


def tile_for(b: int, h: int, w: int) -> int:
    """The narrow kernel's output tile edge for a (b, h, w) input."""
    small, wide = TILES
    ctas = b * -(-h // wide) * -(-w // wide)
    return wide if ctas >= WIDE_TILE_CTAS else small


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch's kernel ("narrow" or "wgmma") and layout: the output
    tile edge, its CTAs and their waves on the card, the dynamic shared
    memory in bytes, the sources; the columns a chunk (``nc``) and the
    chunks over the padded Cout, the channels a weight stage holds (``kc``;
    the narrow kernel's one stage holds every channel of a tap), x staged
    whole or ``kc`` channels at a time, the weight stages in the ring, the
    CTAs a cluster and the 64-row m-tiles of conv1 (the wgmma kernel's;
    the narrow kernel runs 16-row tiles, 0 here)."""

    kernel: str
    tile: int
    ctas: int
    waves: int
    smem_bytes: int
    sources: int
    nc: int
    column_passes: int
    kc: int
    x_chunked: bool
    stages: int
    cluster: int
    m_tiles: int


def narrow_smem_bytes(tile: int, cin_pad: int, cout: int,
                      dtype: torch.dtype) -> int:
    """The narrow kernel's shared memory (``Smem`` in
    csrc/fused_resblock.cu): the x tile with its 2-pixel halo, the h tile
    with its 1-pixel halo (Cout channels) and the ring of one tap's
    max(Cin, Cout) x Cout weights a stage, rows padded."""
    pad = _PAD[dtype]
    rows = max(cin_pad, cout)
    x = (tile + 4) ** 2 * (cin_pad + pad)
    h = (tile + 2) ** 2 * (cout + pad)
    return _size(dtype) * (x + h + _STAGES * rows * (cout + 8))


def wgmma_smem_bytes(tile: int, cin_pad: int, cout_pad: int, kc: int,
                     x_chunked: bool, nc: int, stages: int,
                     dtype: torch.dtype) -> int:
    """The wgmma kernel's shared memory (``WideSmem`` in
    csrc/fused_resblock.cu): up to 1024 bytes to align the ring, the ring
    of weight stages (planes of nc rows of kc channels), the x tile with
    its 2-pixel halo (all cin_pad channels, or two buffers of kc), the h
    tile with its 1-pixel halo (all cout_pad channels, which conv2 needs
    whole), rows padded, and a full and an empty barrier a stage."""
    pad, size = _PAD[dtype], _size(dtype)
    ring = stages * _PLANES[dtype] * nc * kc * size
    x = (2 if x_chunked else 1) * (tile + 4) ** 2 * (
        (kc if x_chunked else cin_pad) + pad) * size
    h = (tile + 2) ** 2 * (cout_pad + pad) * size
    return 1024 + ring + x + h + 16 * stages


def _size(dtype: torch.dtype) -> int:
    return torch.finfo(dtype).bits // 8


def _m_tiles(rows: int) -> int:
    return -(-rows // 64)


def wgmma_m_tiles(nc: int, dtype: torch.dtype) -> int:
    """The most 64-row m-tiles a phase of the wgmma kernel may have at nc
    columns a chunk (``wide_mtiles`` in csrc/fused_resblock.cu)."""
    return 512 // (nc * _ACC_SETS[dtype])


def _grid(batch: int, h: int, w: int, t: int) -> int:
    return batch * -(-h // t) * -(-w // t)


def _tile_cost(batch: int, h: int, w: int, t: int) -> tuple[int, int]:
    """The wgmma kernel's cost of tile edge t, to be least: its waves of
    CTAs on the card times the 64-row m-tiles a CTA multiplies (conv1 over
    the tile and its halo, conv2 over the tile), then the larger edge."""
    waves = -(-_grid(batch, h, w, t) // SMS)
    return waves * (_m_tiles((t + 2) ** 2) + _m_tiles(t * t)), -t


def _narrow_plan(batch, h, w, cin, cout, dtype, sources, tile):
    """The narrow kernel's plan, or None where it does not apply: Cout 32
    or 64, at the tile rule's edge (or ``tile``), x whole and every
    channel of a tap in one stage within SMEM_LIMIT."""
    if cout not in _NARROW_COLS:
        return None
    t = tile or tile_for(batch, h, w)
    cin_pad = -(-cin // _STEP[dtype]) * _STEP[dtype]
    nbytes = narrow_smem_bytes(t, cin_pad, cout, dtype)
    ctas = _grid(batch, h, w, t)
    if nbytes > SMEM_LIMIT or ctas > _INT_MAX:
        return None
    return Plan("narrow", t, ctas, -(-ctas // SMS), nbytes, sources, cout,
                1, max(cin_pad, cout), False, _STAGES, 1, 0)


def _wgmma_plan(batch, h, w, cin, cout, dtype, sources, tile, cluster):
    """The wgmma kernel's plan: the tile edges by ``_tile_cost`` (or
    ``tile`` alone), and at the first that fits: the widest column chunk
    dividing the padded Cout whose m-tiles the accumulators hold, the first
    of ``_LAYOUTS`` within SMEM_LIMIT (a stage twice as wide as every
    channel count is skipped); clusters of ``cluster`` CTAs where the grid
    divides, else 1."""
    step, size = _STEP[dtype], _size(dtype)
    cin_pad = -(-cin // step) * step
    cout_pad = -(-cout // 32) * 32
    tiles = [tile] if tile else sorted(
        range(1, _MAX_TILE + 1), key=lambda t: _tile_cost(batch, h, w, t))
    for t in tiles:
        ctas = _grid(batch, h, w, t)
        m_tiles = _m_tiles((t + 2) ** 2)
        nc = next((n for n in _WGMMA_COLS if cout_pad % n == 0
                   and m_tiles <= wgmma_m_tiles(n, dtype)), None)
        if ctas > _INT_MAX or nc is None:
            continue
        for x_chunked, atom, stages in _LAYOUTS:
            kc = atom // size
            if atom > 32 and kc // 2 >= max(cin_pad, cout_pad):
                continue
            if x_chunked and kc >= cin_pad:
                continue
            nbytes = wgmma_smem_bytes(t, cin_pad, cout_pad, kc, x_chunked,
                                      nc, stages, dtype)
            if nbytes <= SMEM_LIMIT:
                return Plan("wgmma", t, ctas, -(-ctas // SMS), nbytes,
                            sources, nc, cout_pad // nc, kc, x_chunked,
                            stages, cluster if ctas % cluster == 0 else 1,
                            m_tiles)
    return None


def plan(batch: int, h: int, w: int, cin: int, cout: int,
         dtype: torch.dtype, *, sources: int = 1, tile: int | None = None,
         kernel: str | None = None, cluster: int = CLUSTER) -> Plan:
    """The kernel and its plan for a (batch, h, w, cin) input and cout
    outputs from one source or two (``fused_resblock_split``, whose gather
    fills the same rows, so the plan is the same): the narrow kernel where
    it applies (``_narrow_plan``: the UNet's blocks), else the wgmma kernel
    (``_wgmma_plan``); ``kernel`` names one, ``tile`` forces the edge and
    ``cluster`` the wgmma kernel's cluster (the comparisons of
    ``resblock_tile_ab`` and ``chip_smoke.py``). Raises ValueError, before
    any launch, where none fits."""
    if dtype not in _STEP:
        raise TypeError(f"the fused resblock kernel takes float32 or "
                        f"bfloat16, not {dtype}")
    if sources not in (1, 2):
        raise ValueError(f"sources must be 1 or 2, got {sources}")
    if kernel not in (None, *KERNELS):
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    if cluster not in (1, 2, 4):
        raise ValueError(f"cluster must be 1, 2 or 4, got {cluster}")
    if min(batch, h, w, cin, cout) <= 0:
        raise ValueError(f"the fused resblock needs positive sizes, got "
                         f"batch {batch}, {h} x {w}, Cin {cin}, Cout {cout}")
    args = (batch, h, w, cin, cout, dtype, sources, tile)
    if kernel != "wgmma":
        p = _narrow_plan(*args)
        if p is not None or kernel == "narrow":
            if p is None:
                raise ValueError(
                    f"Cin={cin}, Cout={cout} ({str(dtype)[6:]}): not a plan "
                    f"of the narrow kernel (Cout 32 or 64, x whole within "
                    f"{SMEM_LIMIT} bytes of shared memory)")
            return p
    p = _wgmma_plan(*args, cluster)
    if p is None:
        raise ValueError(
            f"Cin={cin}, Cout={cout} ({str(dtype)[6:]}) at tile "
            f"{tile or 1}: the fused resblock kernel needs more shared memory "
            f"a block than the H100's limit of {SMEM_LIMIT} (its h tile "
            f"holds all Cout channels of the tile and its halo)")
    return p


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
           upsample_a: int = 1, *, tile: int | None = None,
           kernel: str | None = None, cluster: int = CLUSTER) -> Plan:
    """Raise before a launch on what the kernel does not take; return its
    plan (``tile``, ``kernel`` and ``cluster`` as ``plan``'s)."""
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
    return plan(b, h, w, cin, cout, x.dtype, sources=1 if x_b is None else 2,
                tile=tile, kernel=kernel, cluster=cluster)


def _taps(weight: torch.Tensor) -> torch.Tensor:
    """torch's (Cout, Cin, k, k) conv weight as the narrow kernel's
    tap-major (k k, Cin, Cout) copy."""
    cout, cin = weight.shape[:2]
    return weight.permute(2, 3, 1, 0).reshape(-1, cin, cout).contiguous()


def kmajor_taps(weight: torch.Tensor, cout_pad: int,
                k_pad: int) -> torch.Tensor:
    """torch's (Cout, Cin, k, k) conv weight as the wgmma kernel's K-major
    (k k, Cout_pad, K_pad) copy: tap ky k + kx, a row per output channel,
    its input channels contiguous, zeros past Cout and Cin."""
    cout, cin = weight.shape[:2]
    taps = weight.permute(2, 3, 0, 1).reshape(-1, cout, cin)
    return F.pad(taps, (0, k_pad - cin, 0, cout_pad - cout)).contiguous()


def weight_planes(weight: torch.Tensor, cout_pad: int,
                  k_pad: int) -> torch.Tensor:
    """A weight as the wgmma kernel reads it: ``kmajor_taps`` in planes,
    float32 as 3xTF32's (big = the weight rounded to TF32, small = the
    rest rounded to TF32, so big + small is the weight within 2^-22 of it;
    TF32 rounding is to nearest, ties away from zero, as the card's
    ``cvt.rna.tf32.f32``: the low 13 bits 0), bfloat16 as one. The wrapper
    packs them on every call: in training the weights change every step,
    and two planes from the wrapper cost the kernel nothing but their
    bytes, where a split in shared memory would cost a pass and a barrier
    a stage."""
    taps = kmajor_taps(weight, cout_pad, k_pad)
    if weight.dtype != torch.float32:
        return taps[None]
    planes = torch.empty((2, *taps.shape), dtype=taps.dtype,
                         device=taps.device)
    big, small = planes.view(torch.int32)
    torch.bitwise_and(taps.view(torch.int32) + 0x1000, -0x2000, out=big)
    torch.sub(taps, planes[0], out=planes[1])
    small.add_(0x1000).bitwise_and_(-0x2000)
    return planes


def _kernel_args(x, w1, b1, w2, b2, time_bias, ws=None, bs=None, *,
                 x_b=None, upsample_a: int = 1, tile: int | None = None,
                 kernel: str | None = None, cluster: int = CLUSTER):
    """(plan, output, the plan's C entry point's arguments but the stream,
    the tensors they point into) of one launch; checks and plans first."""
    p = _check(x, w1, b1, w2, b2, time_bias, ws, bs, x_b, upsample_a,
               tile=tile, kernel=kernel, cluster=cluster)
    b, h, w, cin = _input_shape(x, x_b, upsample_a)
    cout = w1.shape[0]
    x = x.contiguous()
    sources = [x] if x_b is None else [x, x_b.contiguous()]
    if p.kernel == "narrow":
        weights = [_taps(w1), _taps(w2), None if ws is None else _taps(ws)]
    else:
        step = _STEP[x.dtype]
        cin_pad, cout_pad = -(-cin // step) * step, p.nc * p.column_passes
        weights = [weight_planes(w1, cout_pad, cin_pad),
                   weight_planes(w2, cout_pad, cout_pad),
                   None if ws is None else weight_planes(ws, cout_pad,
                                                         cin_pad)]
    vectors = [b1.contiguous(), time_bias.reshape(b, cout).contiguous(),
               b2.contiguous(), None if bs is None else bs.contiguous()]
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    # The widest copy of the sources' pixel rows into shared memory: every
    # row of each starts on a multiple of it.
    size = x.element_size()
    vec = math.gcd(16, *(n for s in sources
                         for n in (s.data_ptr(), s.shape[-1] * size)))
    args = (x.data_ptr(), None if x_b is None else sources[1].data_ptr(),
            ptr(weights[0]), ptr(vectors[0]), ptr(vectors[1]),
            ptr(weights[1]), ptr(vectors[2]), ptr(weights[2]),
            ptr(vectors[3]), out.data_ptr(), _DTYPE_CODES[x.dtype], b, h, w,
            cin, x.shape[-1], upsample_a, cout, p.tile)
    if p.kernel == "wgmma":
        args += (p.kc, p.stages, int(p.x_chunked), p.nc, p.cluster)
    args += (vec, p.smem_bytes)
    return p, out, args, (sources, weights, vectors)


def _launch(x, w1, b1, w2, b2, time_bias, ws=None, bs=None, *, x_b=None,
            upsample_a: int = 1, tile: int | None = None,
            kernel: str | None = None,
            cluster: int = CLUSTER) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors; returns (B, H, W, Cout) in
    x's dtype. With ``x_b``, x is x_a and the block's input is
    cat(upsample(x_a, upsample_a), x_b). The weights are packed for the
    plan's kernel on each call (no cache: in training they change every
    step). ``tile``, ``kernel`` and ``cluster`` override the plan's, for
    ``resblock_tile_ab``'s and ``chip_smoke.py``'s comparisons."""
    global launches
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"x is on {x.device} but the current CUDA device is "
                         f"{torch.cuda.current_device()}")
    p, out, args, _keep = _kernel_args(x, w1, b1, w2, b2, time_bias, ws, bs,
                                       x_b=x_b, upsample_a=upsample_a,
                                       tile=tile, kernel=kernel,
                                       cluster=cluster)
    if p.kernel == "narrow":
        entry = _build.function("tdm_fused_resblock_narrow", _NARROW_ARGTYPES)
    else:
        entry = _build.function("tdm_fused_resblock_wgmma", _WGMMA_ARGTYPES)
    err = entry(*args, torch.cuda.current_stream(x.device).cuda_stream)
    _build.raise_on(err, "fused resblock")
    launches += 1
    return out


def wgmma_attributes(p: Plan, dtype: torch.dtype) -> dict:
    """The wgmma instance of plan ``p`` on the card: its registers and
    local (spill) bytes a thread, and the clusters of ``p.cluster`` CTAs
    with ``p.smem_bytes`` each that the card holds at once."""
    out = (ctypes.c_int * 3)()
    err = _build.function("tdm_fused_resblock_wgmma_attrs", _ATTRS_ARGTYPES)(
        _DTYPE_CODES[dtype], p.nc, p.smem_bytes, p.cluster, out)
    _build.raise_on(err, "fused resblock attributes")
    return {"registers": out[0], "local_bytes": out[1],
            "max_active_clusters": out[2]}


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
