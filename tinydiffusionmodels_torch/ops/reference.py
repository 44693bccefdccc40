"""Plain PyTorch versions of the kernels: their semantics contract.

Port of ``ops/xla_ref.attention`` (the JAX package's plain version), widened
to what the flash kernels compute: the output and the per-row float32
logsumexp, an optional causal predicate on global positions, values whose
width may differ from the keys', and the TPU flash kernel's attention-weight
dropout with its coordinate-hash mask (``dropout_scale``). The CPU tests and
the CPU path of the models run this, forward and (by autograd) backward;
``chip_smoke.py`` holds the CUDA kernels against it on the card.

``fused_guided_decode`` is the plain version of the guided-decode kernel
(``ops/decode_kernel.py``, ``csrc/guided_decode.cu``), and
``fused_resblock`` that of the UNet residual-block kernel
(``ops/resblock.py``, ``csrc/fused_resblock.cu``).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

LAYOUTS = ("bhld", "blhd")

_MASK32 = 0xFFFFFFFF


def dropout_threshold(rate: float) -> int:
    """The uint32 threshold of ``dropout_scale``: a weight is kept where its
    hash is at least this (``pallas_kernels._dropout_scale``)."""
    return min(int(rate * 2**32), 2**32 - 1)


def dropout_scale(seed, bh, q_pos, k_pos, rate: float) -> torch.Tensor:
    """Counter-based dropout mask: 0 or 1/(1-rate) per attention weight.

    Bit-exact port of ``pallas_kernels._dropout_scale``: the murmur3 fmix32
    mix of ``q*0x9E3779B9 + k*0x85EBCA6B + bh*0xC2B2AE35 + seed`` in uint32
    arithmetic, kept where the hash is >= ``dropout_threshold(rate)``. The
    arithmetic runs in int64 masked to 32 bits, because torch's uint32 has
    no right shift on the CPU. ``seed`` is an int or an integer tensor (its
    low 32 bits count, as ``astype(uint32)`` of the TPU's int32 seed);
    ``bh``, ``q_pos`` and ``k_pos`` are ints or integer tensors that
    broadcast together. Returns float32 on the device of the tensor inputs.
    """
    tensors = [a for a in (seed, bh, q_pos, k_pos) if torch.is_tensor(a)]
    device = tensors[0].device if tensors else None

    def u32(a):
        return torch.as_tensor(a, dtype=torch.int64, device=device) & _MASK32

    h = (
        u32(q_pos) * 0x9E3779B9 + u32(k_pos) * 0x85EBCA6B
        + u32(bh) * 0xC2B2AE35 + u32(seed)
    ) & _MASK32
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _MASK32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _MASK32
    h = h ^ (h >> 16)
    keep = h >= dropout_threshold(rate)
    # float32 of 1/(1-rate), as the TPU kernel's jnp.float32(1 / (1 - rate)).
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32)
    return torch.where(keep, scale.to(keep.device), 0.0)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    layout: str = "bhld",
    q_offset: int = 0,
    k_offset: int = 0,
    dropout_rate: float = 0.0,
    dropout_seed: torch.Tensor | int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """softmax(q k^T / sqrt(Dh)) v, and its logsumexp.

    q: (B, H, Lq, Dh), k: (B, H, Lk, Dh), v: (B, H, Lk, Dv) for
    ``layout='bhld'``; (B, L, H, D) for ``'blhd'``, the layout straight out of
    a fused QKV projection. Returns ``out`` in the input layout and dtype and
    ``lse`` as (B, H, Lq) float32 in either layout. Scores are formed in
    float32. ``causal`` keeps key j for query i where
    ``q_offset + i >= k_offset + j``; masked scores take float32's lowest
    finite value, as the TPU kernel's do, so a row with no visible key
    averages the Lk values instead of producing NaN.

    ``dropout_rate`` > 0 drops attention weights as the TPU flash kernel
    does (torch semantics): after the softmax, so the normalizer and the
    lse are those of the undropped weights, with the mask
    ``dropout_scale(dropout_seed, b * H + h, q_offset + i, k_offset + j)``.
    """
    if layout not in LAYOUTS:
        raise ValueError(f"unknown attention layout: {layout!r}")
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    if layout == "blhd":
        q, k, v = (a.transpose(1, 2) for a in (q, k, v))
    b, h, lq, dh = q.shape
    lk = k.shape[-2]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(dh)
    q_pos = q_offset + torch.arange(lq, device=q.device)
    k_pos = k_offset + torch.arange(lk, device=q.device)
    if causal:
        keep = q_pos[:, None] >= k_pos[None, :]
        scores = scores.masked_fill(~keep, torch.finfo(torch.float32).min)
    lse = torch.logsumexp(scores, dim=-1)
    weights = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0:
        bh = torch.arange(b * h, device=q.device).reshape(b, h, 1, 1)
        weights = weights * dropout_scale(
            dropout_seed, bh, q_pos[:, None], k_pos[None, :], dropout_rate
        )
    out = torch.matmul(weights, v.float()).to(q.dtype)
    if layout == "blhd":
        out = out.transpose(1, 2)
    return out, lse


def _layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor):
    """f32 LayerNorm (eps 1e-5) with bf16 scale and bias, as
    ``decode_kernel._layernorm``."""
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * scale.float() + bias.float()


def _bf16_matmul(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """(B, in) f32 activations rounded to bf16, times a bf16 (in, out)
    weight, summed in f32 (``decode_kernel._matmul``)."""
    out = x.bfloat16().float() @ w.float()
    return out if b is None else out + b.float()


def fused_guided_decode(w, diff_logits: torch.Tensor, bos: int, *,
                        alpha: float = 0.5, temperature: float = 1.0,
                        normalize: bool = False, return_scores: bool = False,
                        forced_tokens: torch.Tensor | None = None):
    """Plain version of the guided-decode kernel, step by step in PyTorch.

    ``w`` is an ``ops.decode_kernel.DecodeWeights`` (bf16). Per position:
    token and position embedding, ``depth`` pre-LN GPT blocks with a bf16
    KV cache, final LN, the bf16 head, then ``mix_logits`` (raw, or the
    mixture probability with ``normalize``) of the head's and the bf16
    diffusion logits, both over ``temperature``, and the greedy argmax
    (lowest index on ties), which is the next position's token.
    Activations are rounded to bf16 before each product; LN, softmax, the
    mix and every sum are f32. Runs on any device (the tests on the CPU,
    ``chip_smoke.py`` on the card beside the kernel). Returns (B, L) int32
    tokens, and with ``return_scores`` also the (B, L, V) f32 mixed scores
    whose argmax each token is. ``forced_tokens`` (B, L) feeds those tokens
    forward instead of its own argmax (teacher forcing), so the scores are
    those of another decode's context: ``chip_smoke.py`` scores the
    kernel's tokens this way at every position.
    """
    b, seq_len, _ = diff_logits.shape
    dev = diff_logits.device
    depth, d = w.ln.shape[0], w.tok_emb.shape[1]
    h = w.n_heads
    dh = d // h
    inv_t = torch.tensor(1.0 / temperature, dtype=torch.float32, device=dev)
    diff = diff_logits.to(torch.bfloat16).float()
    kc = torch.zeros(depth, b, h, seq_len, dh, dtype=torch.bfloat16,
                     device=dev)
    vc = torch.zeros_like(kc)
    tok = torch.full((b,), int(bos), dtype=torch.long, device=dev)
    tokens = torch.empty((b, seq_len), dtype=torch.int32, device=dev)
    scores = []
    for pos in range(seq_len):
        x = w.tok_emb[tok].float() + w.pos_emb[pos].float()
        for i in range(depth):
            ln1w, ln1b, ln2w, ln2b = w.ln[i]
            qkv = _bf16_matmul(_layernorm(x, ln1w, ln1b), w.qkv_w[i],
                               w.qkv_b[i])
            q, k, v = (a.reshape(b, h, dh) for a in qkv.split(d, dim=-1))
            kc[i, :, :, pos] = k.bfloat16()
            vc[i, :, :, pos] = v.bfloat16()
            s = (q[:, :, None, :] * kc[i, :, :, :pos + 1].float()).sum(-1)
            s = s / math.sqrt(dh)                          # (B, H, pos + 1)
            p = torch.exp(s - s.max(-1, keepdim=True).values)
            p = p / p.sum(-1, keepdim=True)
            attn = (p[..., None] * vc[i, :, :, :pos + 1].float()).sum(-2)
            x = x + _bf16_matmul(attn.reshape(b, d), w.proj_w[i], w.proj_b[i])
            hid = _bf16_matmul(_layernorm(x, ln2w, ln2b), w.fc_w[i],
                               w.fc_b[i])
            hid = torch.nn.functional.gelu(hid, approximate="tanh")
            x = x + _bf16_matmul(hid, w.mlp_w[i], w.mlp_b[i])
        x = _layernorm(x, w.ln_f[0], w.ln_f[1])
        a = _bf16_matmul(x, w.head) * inv_t
        dl = diff[:, pos] * inv_t
        if normalize:
            ma = a.max(-1, keepdim=True).values
            md = dl.max(-1, keepdim=True).values
            za = torch.exp(a - ma).sum(-1, keepdim=True)
            zd = torch.exp(dl - md).sum(-1, keepdim=True)
            mixed = ((1.0 - alpha) * torch.exp(a - ma) / za
                     + alpha * torch.exp(dl - md) / zd)
        else:
            mixed = (1.0 - alpha) * a + alpha * dl
        tok = torch.argmax(mixed, dim=-1)
        tokens[:, pos] = tok.to(torch.int32)
        if forced_tokens is not None:
            tok = forced_tokens[:, pos].long()
        if return_scores:
            scores.append(mixed)
    if return_scores:
        return tokens, torch.stack(scores, dim=1)
    return tokens


@contextlib.contextmanager
def full_f32_convs():
    """cuDNN convolutions in full float32 inside the block: PyTorch's
    default runs float32 convolutions on the card in TF32, which keeps ~3
    decimal digits. A no-op on the CPU."""
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = allow


def fused_resblock(x, w1, b1, w2, b2, time_bias, ws=None, bs=None):
    """Plain version of the fused residual block (``xla_ref.fused_resblock``,
    reference src/mnist.py:56-61):

        h = relu(conv3x3(x) + b1) + time_bias
        out = relu(conv3x3(h) + b2) + skip(x)

    x is (B, H, W, Cin) NHWC and so is the output (B, H, W, Cout); the conv
    weights are torch's OIHW tensors ((Cout, Cin, 3, 3), (Cout, Cout, 3, 3)
    and, for a 1x1 skip, (Cout, Cin, 1, 1) with bias ``bs``; ``ws=None`` is
    the identity skip); ``time_bias`` is (B, 1, 1, Cout). The convolutions
    are SAME-padded, so conv2 sees 0 outside the image, as the TPU kernel's
    re-zeroed border gives it. Full float32 on every device."""
    with full_f32_convs():
        xc = x.permute(0, 3, 1, 2)
        h = F.relu(F.conv2d(xc, w1, b1, padding=1))
        h = h + time_bias.permute(0, 3, 1, 2)
        h = F.relu(F.conv2d(h, w2, b2, padding=1))
        skip = xc if ws is None else F.conv2d(xc, ws, bs)
        return (h + skip).permute(0, 2, 3, 1)
