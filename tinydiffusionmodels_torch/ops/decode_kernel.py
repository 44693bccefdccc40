"""The persistent guided-decode kernel: its wrapper and its weight packing.

Port of ``tinydiffusionmodels_tpu/ops/decode_kernel.py``: the whole greedy
AR + diffusion decode of a TinyGPT, all L positions, in one launch of the
hand-written CUDA kernel ``csrc/guided_decode.cu`` (its header says what
bounds it on the card and what the design does about that). The output is
a bf16 *draft*: ``sample.guided.guided_generate_verified`` refines it to the
exact f32 greedy fixpoint.

Dispatch is on the device of the diffusion logits alone. A CPU tensor runs
the plain PyTorch version (``reference.fused_guided_decode``, the same
arithmetic step by step); a CUDA tensor launches the kernel or raises. There
is no fallback from one to the other and no batch threshold: the kernel
takes any batch in one launch. The TPU's VMEM planner (``fits_vmem``,
``_pick_chunk`` and the batch-chunk grid) does not carry over.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from tinydiffusionmodels_torch import perf
from tinydiffusionmodels_torch.ops import _build, reference

# Launches of the kernel made by this process: incremented once per launch
# and nowhere else; callers reset it to 0 to count a run.
launches = 0

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_ARGTYPES = ([_PTR] * 17 + [_INT] * 9 + [ctypes.c_float] * 3
             + [_INT, _PTR, _PTR, _INT, _INT, _PTR, _PTR])

# The kernel's phases, in the order of its plan and packed matrices.
PHASES = ("qkv", "proj", "fc", "mlp", "head")
WARPS = 8                   # warps of a CTA (256 threads)
SMEM_MAX = 232_448          # shared memory a CTA may use on the H100
_ROWS = (16, 32, 64)        # batch rows of a unit (m16 tiles of a warp <= 4)
_NCOLS = (1, 2, 4, 8, 16)   # n8 column blocks of a unit (<= 2 a warp)
SCORE_CHUNK = 256           # attention scores a warp holds (kScoreChunk)
OUT_CHUNK = 256             # and output columns of a head (kOutChunk)
_PLAN_INTS = 8              # ints of a phase's plan (kPlanInts)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def pack_fragments(w: torch.Tensor) -> torch.Tensor:
    """A bf16 (K, N) weight (in, out) -> the kernel's packed layout, shape
    (ceil(N / 8), ceil(K / 32), 32, 8): for each n8 column block and k32
    chunk, the eight bf16 each lane holds as its mma.sync m16n8k16 B
    fragments for the chunk's two k16 steps (lane 4 g + t: column g, rows
    2t, 2t + 1, 2t + 8, 2t + 9 of each step), so a lane loads 16 bytes and
    a warp 512 contiguous bytes. K and N are zero-padded.
    ``unpack_fragments`` inverts it."""
    k, n = w.shape
    kc, n8 = _ceil(k, 32), _ceil(n, 8)
    padded = w.new_zeros(kc * 32, n8 * 8)
    padded[:k, :n] = w
    # k = 32 c + 16 s + 8 half + 2 t + pair; n = 8 j + g
    x = padded.reshape(kc, 2, 2, 4, 2, n8, 8)
    return x.permute(5, 0, 6, 3, 1, 2, 4).reshape(n8, kc, 32, 8).contiguous()


def unpack_fragments(p: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """The (K, N) weight a ``pack_fragments`` layout holds."""
    n8, kc = p.shape[:2]
    x = p.reshape(n8, kc, 8, 4, 2, 2, 2).permute(1, 4, 5, 3, 6, 0, 2)
    return x.reshape(kc * 32, n8 * 8)[:k, :n]


@dataclasses.dataclass(frozen=True)
class DecodeWeights:
    """A TinyGPT's weights as the kernel and its plain version read them:
    bf16, contiguous, linear weights (in, out), layers stacked on a leading
    depth axis. The ``*_p`` tensors are the five matrices again in the
    kernel's packed fragment layout (``pack_fragments``), which only the
    kernel reads."""

    tok_emb: torch.Tensor   # (V, D)
    pos_emb: torch.Tensor   # (T, D)
    ln: torch.Tensor        # (depth, 4, D): ln1 scale, ln1 bias, ln2 scale, bias
    qkv_w: torch.Tensor     # (depth, D, 3D)
    qkv_b: torch.Tensor     # (depth, 3D)
    proj_w: torch.Tensor    # (depth, D, D)
    proj_b: torch.Tensor    # (depth, D)
    fc_w: torch.Tensor      # (depth, D, F)
    fc_b: torch.Tensor      # (depth, F)
    mlp_w: torch.Tensor     # (depth, F, D)
    mlp_b: torch.Tensor     # (depth, D)
    ln_f: torch.Tensor      # (2, D): scale, bias
    head: torch.Tensor      # (D, V)
    qkv_p: torch.Tensor     # (depth, ceil(3D / 8), KC, 32, 8)
    proj_p: torch.Tensor    # (depth, ceil(D / 8), KC, 32, 8)
    fc_p: torch.Tensor      # (depth, ceil(F / 8), KC, 32, 8)
    mlp_p: torch.Tensor     # (depth, ceil(D / 8), KC(F), 32, 8)
    head_p: torch.Tensor    # (ceil(V / 8), KC, 32, 8)
    n_heads: int

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self)
                     if f.name != "n_heads")

    def packed(self) -> tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f"{ph}_p") for ph in PHASES)


def pack_weights(model) -> DecodeWeights:
    """A ``models.ar_lm.TinyGPT`` -> its bf16 ``DecodeWeights``, on the
    model's device (the JAX wrapper's ``_cast_weights``), with the kernel's
    packed matrices built once here. ValueError for another base LM: the
    kernel serves TinyGPT alone, as in the JAX CLI."""
    from tinydiffusionmodels_torch.models.ar_lm import TinyGPT

    if not isinstance(model, TinyGPT):
        raise ValueError(f"the decode kernel packs a TinyGPT's weights; a "
                         f"{type(model).__name__} decodes with draft='plain'")

    def bf(t):
        return t.detach().to(torch.bfloat16).contiguous()

    def stack(fn):
        return bf(torch.stack([fn(blk) for blk in model.blocks]))

    def packed(w):
        return torch.stack([pack_fragments(x) for x in w])

    with torch.no_grad():
        qkv_w = stack(lambda b: b.attn["qkv"].weight.T)
        proj_w = stack(lambda b: b.attn["proj"].weight.T)
        fc_w = stack(lambda b: b.mlp["fc"].weight.T)
        mlp_w = stack(lambda b: b.mlp["proj"].weight.T)
        head = bf(model.lm_head.weight.T)
        return DecodeWeights(
            tok_emb=bf(model.tok_emb.weight),
            pos_emb=bf(model.pos_emb.weight),
            ln=stack(lambda b: torch.stack([b.ln1.weight, b.ln1.bias,
                                            b.ln2.weight, b.ln2.bias])),
            qkv_w=qkv_w,
            qkv_b=stack(lambda b: b.attn["qkv"].bias),
            proj_w=proj_w,
            proj_b=stack(lambda b: b.attn["proj"].bias),
            fc_w=fc_w,
            fc_b=stack(lambda b: b.mlp["fc"].bias),
            mlp_w=mlp_w,
            mlp_b=stack(lambda b: b.mlp["proj"].bias),
            ln_f=bf(torch.stack([model.ln_f.weight, model.ln_f.bias])),
            head=head,
            qkv_p=packed(qkv_w), proj_p=packed(proj_w),
            fc_p=packed(fc_w), mlp_p=packed(mlp_w),
            head_p=pack_fragments(head),
            n_heads=model.cfg.n_heads,
        )


@dataclasses.dataclass(frozen=True)
class PhasePlan:
    """One phase's tiling: a unit is ``rows`` batch rows x ``ncols`` n8
    column blocks x ``kchunks`` k32 chunks, staged ``ktile`` chunks at a
    time; ``ksplit`` units share a tile of outputs and split K (their
    partial sums are added by the consumer, in order). Units are numbered
    (row tile, k split, column group), the column group fastest, and each
    CTA takes a contiguous run of them."""

    rows: int
    ncols: int
    kchunks: int
    row_tiles: int
    col_groups: int
    ksplit: int
    ktile: int

    @property
    def units(self) -> int:
        return self.row_tiles * self.col_groups * self.ksplit

    @property
    def warp_split(self) -> tuple[int, int]:
        """(n8 blocks a warp takes, warps that split the unit's K)."""
        ncw = min(self.ncols, WARPS)
        return self.ncols // ncw, WARPS // ncw

    def ints(self) -> list[int]:
        return [self.rows, self.ncols, self.kchunks, self.row_tiles,
                self.col_groups, self.ksplit, self.units, self.ktile]

    def tile_bytes(self, ktile: int) -> int:
        """Shared memory of a K tile: the left factor (rows of ktile k32
        chunks and 8 bf16 of padding), then the packed weights."""
        return self.rows * (ktile * 32 + 8) * 2 + self.ncols * ktile * 512

    def red_bytes(self) -> int:
        nbw, ksub = self.warp_split
        return ksub * self.rows * self.ncols * 8 * 4


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """The launch: each phase's tiling, the grid, and the shared memory: a
    K tile at 0, the reduction tile at ``red_off``, the attention's scores
    and partial outputs at ``att_off``, the staged rows' LayerNorm
    statistics at ``stat_off``."""

    phases: dict
    grid: int
    red_off: int
    att_off: int
    stat_off: int
    smem: int

    def ints(self) -> list[int]:
        return [i for ph in PHASES for i in self.phases[ph].ints()]


def _dims(vocab, d, ffn):
    """Per phase: (True where a unit takes K whole, total K chunks, n8
    blocks). The LayerNorm phases take whole rows; the projection and the
    MLP may split K."""
    kd = _ceil(d, 32)
    return {"qkv": (True, kd, _ceil(3 * d, 8)),
            "proj": (False, kd, _ceil(d, 8)),
            "fc": (True, kd, _ceil(ffn, 8)),
            "mlp": (False, _ceil(ffn, 32), _ceil(d, 8)),
            "head": (True, kd, _ceil(vocab, 8))}


def _tiling(whole: bool, kc: int, n8: int, b: int, sms: int) -> PhasePlan:
    """A phase's units fill one wave of the card: the narrowest unit (of
    _NCOLS n8 blocks, no wider than the phase) whose units are at most one
    a CTA on ``sms`` SMs, at 16 rows, or 32 or 64 where even the widest
    16-row unit gives more (and B has the rows); failing that, the fewest
    units. Where K may be split, K is halved while the units still fit the
    wave. ``ktile`` is set by ``plan``."""
    shapes = [(rows, nc) for rows in _ROWS if rows == 16 or rows // 2 < b
              for nc in _NCOLS if nc == 1 or nc // 2 < n8]
    rows, ncols = next(
        (sh for sh in shapes if _ceil(b, sh[0]) * _ceil(n8, sh[1]) <= sms),
        shapes[-1])
    units, split = _ceil(b, rows) * _ceil(n8, ncols), 1
    while not whole and units * split * 2 <= sms and split * 2 <= kc:
        split *= 2
    kchunks = _ceil(kc, split)
    return PhasePlan(rows, ncols, kchunks, _ceil(b, rows), _ceil(n8, ncols),
                     _ceil(kc, kchunks), kchunks)


def plan(b: int, vocab: int, d: int, heads: int, ffn: int,
         sms: int) -> DecodePlan:
    """The kernel's tiling for a decode of B rows on a card of ``sms``
    SMs: each phase's units (``_tiling``), the grid (the widest phase's
    units, or the attention's B H, at most one CTA an SM), and the shared
    memory, each phase's ``ktile`` the most of its K chunks whose tile fits
    beside the other regions (all of them at the bench shape). Every shape
    fits: a K tile too wide for the shared memory is cut into several."""
    dims = _dims(vocab, d, ffn)
    phases = {ph: _tiling(*dims[ph], b, sms) for ph in PHASES}
    grid = max(1, min(sms, max(max(pp.units for pp in phases.values()),
                               b * heads)))
    red = max(pp.red_bytes() for pp in phases.values())
    att = WARPS * (SCORE_CHUNK + 4 + min(_ceil(d // heads, 4) * 4,
                                         OUT_CHUNK)) * 4
    stat = max(pp.rows for pp in phases.values()) * 4 * 4
    room = SMEM_MAX - red - att - stat
    for ph, pp in phases.items():
        per = pp.tile_bytes(1) - pp.tile_bytes(0)
        ktile = min(pp.kchunks, (room - pp.tile_bytes(0)) // per)
        assert ktile >= 1, (ph, pp)
        phases[ph] = dataclasses.replace(pp, ktile=ktile)
    red_off = _ceil(max(pp.tile_bytes(pp.ktile) for pp in phases.values()),
                    16) * 16
    att_off = red_off + red
    stat_off = att_off + att
    return DecodePlan(phases, grid, red_off, att_off, stat_off,
                      stat_off + stat)


def work(w: DecodeWeights, b: int, seq_len: int) -> tuple[int, int, int]:
    """(bytes, matmul FLOPs, attention FLOPs) of one decode of ``b`` rows
    and ``seq_len`` positions with the weights ``w``: every bf16 weight
    read once (the position table whole, the token table's rows gathered,
    at most one a decoded token), the bf16 diffusion logits once, the
    int32 tokens written; the matmuls (bf16 weights times bf16-rounded
    activations, f32 sums: the bf16 tensor-core operation) and the
    attention over slots <= pos (f32 queries and probabilities against the
    bf16 cache: f32 operations), at 2 FLOPs per multiply-add."""
    vocab, d = w.tok_emb.shape
    depth, f = w.fc_w.shape[0], w.fc_w.shape[2]
    layer = 3 * d * d + d * d + 2 * d * f
    weights = depth * (layer + 3 * d + d + f + d + 4 * d) + d * vocab + 2 * d
    weights += w.pos_emb.shape[0] * d + min(b * seq_len, vocab) * d
    nbytes = 2 * weights + 2 * b * seq_len * vocab + 4 * b * seq_len
    attn = 2 * 2 * d * depth * sum(p + 1 for p in range(seq_len))
    return nbytes, b * seq_len * 2 * (depth * layer + d * vocab), b * attn


def fused_guided_decode(lm, diff_logits: torch.Tensor, bos: int, *,
                        alpha: float = 0.5, temperature: float = 1.0,
                        normalize: bool = False) -> torch.Tensor:
    """Whole guided decode: (B, L, V) diffusion logits -> (B, L) int32
    greedy tokens of ``lm`` mixed with them (``sample.guided.mix_logits``
    semantics), bf16 weights and cache. ``lm`` is a TinyGPT, packed on each
    call, or its ``DecodeWeights`` (``pack_weights``), packed once by the
    caller. One kernel launch on the card; the plain version on the CPU."""
    w = lm if isinstance(lm, DecodeWeights) else pack_weights(lm)
    kw = dict(alpha=alpha, temperature=temperature, normalize=normalize)
    if diff_logits.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(
            f"the guided decode has no path for {diff_logits.device.type} "
            "tensors")
    b, seq_len = diff_logits.shape[:2]
    with perf.kernel_call(lambda: sum(work(w, b, seq_len)[1:])):
        if diff_logits.device.type == "cpu":
            return reference.fused_guided_decode(w, diff_logits, bos, **kw)
        return _launch(w, diff_logits, bos, **kw)[0]


def _check(w: DecodeWeights, diff: torch.Tensor, bos: int) -> None:
    if diff.dim() != 3:
        raise ValueError(f"diffusion logits must be (B, L, V), got "
                         f"{tuple(diff.shape)}")
    b, seq_len, vocab = diff.shape
    (v, d), t = w.tok_emb.shape, w.pos_emb.shape[0]
    if vocab != v or w.head.shape != (d, v):
        raise ValueError(f"diffusion vocab {vocab} != the LM's {v}")
    if not 1 <= seq_len <= t:
        raise ValueError(f"decode length {seq_len} outside 1..max_len={t}")
    if b < 1 or d % w.n_heads:
        raise ValueError(f"batch {b}, dim {d}, heads {w.n_heads}")
    if not 0 <= int(bos) < v:
        raise ValueError(f"bos token {bos} outside the vocab of {v}")
    for x in w.tensors():
        if x.device != diff.device:
            raise ValueError(f"weights on {x.device}, logits on {diff.device}")
        if x.dtype != torch.bfloat16 or not x.is_contiguous():
            raise ValueError("DecodeWeights must be contiguous bfloat16 "
                             "(build them with pack_weights)")
    if diff.device.index != torch.cuda.current_device():
        raise ValueError(f"logits are on {diff.device} but the current CUDA "
                         f"device is {torch.cuda.current_device()}")


def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def launch_plan(w: DecodeWeights, b: int, sms: int):
    """The ``plan`` of a decode of ``b`` rows with the weights ``w`` on a
    card of ``sms`` SMs."""
    vocab, d = w.tok_emb.shape
    return plan(b, vocab, d, w.n_heads, w.fc_w.shape[2], sms)


def _launch(w: DecodeWeights, diff_logits: torch.Tensor, bos: int, *,
            alpha: float, temperature: float, normalize: bool,
            trace: torch.Tensor | None = None) -> tuple[torch.Tensor, int]:
    """One launch of the kernel on CUDA tensors; allocates its scratch and
    output with ``torch.empty`` on the current stream (the barrier counter
    with ``torch.zeros``). Returns the tokens and the launch's grid (CTAs,
    ``plan``'s). ``trace``, for measurement only, is a zeroed int64 tensor
    of 4 (``barriers(...) + 1``) elements on the card that gets CTA 0's
    ``%globaltimer`` stamps (ns): at the start and when each grid barrier
    released, and in each matmul phase when its first unit was staged and
    multiplied and when its epilogue ended."""
    global launches
    _check(w, diff_logits, bos)
    b, seq_len, vocab = diff_logits.shape
    depth, d = w.ln.shape[0], w.tok_emb.shape[1]
    ffn, t, h = w.fc_w.shape[2], w.pos_emb.shape[0], w.n_heads
    dev = diff_logits.device
    pl = launch_plan(w, b, _sms(dev))
    cgs = pl.phases["head"].col_groups
    splits = pl.phases["proj"].ksplit + pl.phases["mlp"].ksplit
    diff = diff_logits.to(torch.bfloat16).contiguous()
    fws = torch.empty(b * d * (3 + splits) + b * vocab + 3 * b * cgs
                      + 2 * b * seq_len, dtype=torch.float32, device=dev)
    hid = torch.empty(b * (_ceil(ffn, 8) + _ceil(d, 8)) * 8,
                      dtype=torch.bfloat16, device=dev)
    ints = torch.zeros(b * cgs + 1, dtype=torch.int32, device=dev)
    kc = torch.empty(depth * b * t * d, dtype=torch.bfloat16, device=dev)
    vc = torch.empty_like(kc)
    tokens = torch.empty((b, seq_len), dtype=torch.int32, device=dev)
    packed = (_PTR * 5)(*(x.data_ptr() for x in w.packed()))
    packed_kc = (_INT * 5)(*(x.shape[-3] for x in w.packed()))
    plan_ints = (_INT * (_PLAN_INTS * len(PHASES)))(*pl.ints())
    offs = (_INT * 3)(pl.red_off, pl.att_off, pl.stat_off)
    err = _build.function("tdm_guided_decode", _ARGTYPES)(
        w.tok_emb.data_ptr(), w.pos_emb.data_ptr(), w.ln.data_ptr(),
        w.qkv_b.data_ptr(), w.proj_b.data_ptr(), w.fc_b.data_ptr(),
        w.mlp_b.data_ptr(), w.ln_f.data_ptr(), packed, packed_kc,
        diff.data_ptr(), fws.data_ptr(), hid.data_ptr(), ints.data_ptr(),
        kc.data_ptr(), vc.data_ptr(), tokens.data_ptr(),
        b, seq_len, vocab, d, h, ffn, t, depth, int(bos),
        1.0 - float(alpha), float(alpha), 1.0 / float(temperature),
        int(bool(normalize)), plan_ints, offs, pl.grid, pl.smem,
        None if trace is None else trace.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.raise_on(err, "guided decode")
    launches += 1
    return tokens, pl.grid


def barriers(depth: int, seq_len: int, normalize: bool = False) -> int:
    """Grid barriers of one launch: 5 a layer (QKV, attention, projection,
    FC, MLP) and 1 for the head at every position, one more for
    ``normalize``'s reduce and its set-up."""
    per = 5 * depth + 1 + int(normalize)
    return seq_len * per + int(normalize)


def _grid_sync_probe(n_syncs: int, grid: int) -> None:
    """For ``chip_smoke.py``'s barrier timing only, not part of the decode:
    one cooperative launch of ``grid`` CTAs, the decode kernel's block size,
    that runs ``n_syncs`` of the decode's grid barriers and nothing else,
    on the current CUDA stream. ``launches`` does not count it."""
    bar = torch.zeros(1, dtype=torch.int32, device="cuda")
    err = _build.function("tdm_grid_sync_probe", [_INT, _INT, _PTR, _PTR])(
        int(n_syncs), int(grid), bar.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    _build.raise_on(err, "grid sync probe")
