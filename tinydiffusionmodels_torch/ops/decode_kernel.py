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

from tinydiffusionmodels_torch.ops import _build, reference

# Launches of the kernel made by this process: incremented once per launch
# and nowhere else; callers reset it to 0 to count a run.
launches = 0

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_ARGTYPES = ([_PTR] * 18 + [_INT] * 9 + [ctypes.c_float] * 3
             + [_INT, _PTR, ctypes.POINTER(_INT)])


@dataclasses.dataclass(frozen=True)
class DecodeWeights:
    """A TinyGPT's weights as the kernel reads them: bf16, contiguous,
    linear weights (in, out), layers stacked on a leading depth axis."""

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
    n_heads: int

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self)
                     if f.name != "n_heads")


def pack_weights(model) -> DecodeWeights:
    """A ``models.ar_lm.TinyGPT`` -> its bf16 ``DecodeWeights``, on the
    model's device (the JAX wrapper's ``_cast_weights``)."""

    def bf(t):
        return t.detach().to(torch.bfloat16).contiguous()

    def stack(fn):
        return bf(torch.stack([fn(blk) for blk in model.blocks]))

    with torch.no_grad():
        return DecodeWeights(
            tok_emb=bf(model.tok_emb.weight),
            pos_emb=bf(model.pos_emb.weight),
            ln=stack(lambda b: torch.stack([b.ln1.weight, b.ln1.bias,
                                            b.ln2.weight, b.ln2.bias])),
            qkv_w=stack(lambda b: b.attn["qkv"].weight.T),
            qkv_b=stack(lambda b: b.attn["qkv"].bias),
            proj_w=stack(lambda b: b.attn["proj"].weight.T),
            proj_b=stack(lambda b: b.attn["proj"].bias),
            fc_w=stack(lambda b: b.mlp["fc"].weight.T),
            fc_b=stack(lambda b: b.mlp["fc"].bias),
            mlp_w=stack(lambda b: b.mlp["proj"].weight.T),
            mlp_b=stack(lambda b: b.mlp["proj"].bias),
            ln_f=bf(torch.stack([model.ln_f.weight, model.ln_f.bias])),
            head=bf(model.lm_head.weight.T),
            n_heads=model.cfg.n_heads,
        )


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
    if diff_logits.device.type == "cpu":
        return reference.fused_guided_decode(w, diff_logits, bos, **kw)
    if diff_logits.device.type != "cuda":
        raise NotImplementedError(
            f"the guided decode has no path for {diff_logits.device.type} "
            "tensors")
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


def _launch(w: DecodeWeights, diff_logits: torch.Tensor, bos: int, *,
            alpha: float, temperature: float,
            normalize: bool) -> tuple[torch.Tensor, int]:
    """One launch of the kernel on CUDA tensors; allocates its scratch and
    output with ``torch.empty`` on the current stream. Returns the tokens
    and the launch's grid (CTAs, sized by the occupancy calculator)."""
    global launches
    _check(w, diff_logits, bos)
    b, seq_len, vocab = diff_logits.shape
    depth, d = w.ln.shape[0], w.tok_emb.shape[1]
    ffn, t = w.fc_w.shape[2], w.pos_emb.shape[0]
    dev = diff_logits.device
    diff = diff_logits.to(torch.bfloat16).contiguous()
    ws = torch.empty(b * (5 * d + ffn + vocab), dtype=torch.float32,
                     device=dev)
    kc = torch.empty(depth * b * t * d, dtype=torch.bfloat16, device=dev)
    vc = torch.empty_like(kc)
    tokens = torch.empty((b, seq_len), dtype=torch.int32, device=dev)
    grid = _INT(0)
    err = _build.function("tdm_guided_decode", _ARGTYPES)(
        *(x.data_ptr() for x in w.tensors()), diff.data_ptr(), ws.data_ptr(),
        kc.data_ptr(), vc.data_ptr(), tokens.data_ptr(),
        b, seq_len, vocab, d, w.n_heads, ffn, t, depth, int(bos),
        1.0 - float(alpha), float(alpha), 1.0 / float(temperature),
        int(bool(normalize)), torch.cuda.current_stream(dev).cuda_stream,
        ctypes.byref(grid),
    )
    _build.raise_on(err, "guided decode")
    launches += 1
    return tokens, grid.value


def _grid_sync_probe(n_syncs: int, grid: int) -> None:
    """For ``chip_smoke.py``'s barrier timing only, not part of the decode:
    one cooperative launch of ``grid`` CTAs, the decode kernel's block size,
    that runs ``n_syncs`` grid barriers and nothing else, on the current
    CUDA stream. ``launches`` does not count it."""
    err = _build.function("tdm_grid_sync_probe", [_INT, _INT, _PTR])(
        int(n_syncs), int(grid), torch.cuda.current_stream().cuda_stream)
    _build.raise_on(err, "grid sync probe")
