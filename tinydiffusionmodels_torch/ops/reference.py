"""Plain PyTorch versions of the kernels: their semantics contract.

Port of ``ops/xla_ref.attention`` (the JAX package's plain version), widened
to what the flash kernels compute: the output and the per-row float32
logsumexp, an optional causal predicate on global positions, values whose
width may differ from the keys', and the TPU flash kernel's attention-weight
dropout with its coordinate-hash mask (``dropout_scale``). The CPU tests and
the CPU path of the models run this forward; ``chip_smoke.py`` holds the
CUDA kernels against it and its autograd on the card.
``attention_bwd_dq`` and ``attention_bwd_dkv`` are the plain versions of
the flash backward kernels (``ops/flash_attention.py``), the CPU path's
backward.

``fused_guided_decode`` is the plain version of the guided-decode kernel
(``ops/decode_kernel.py``, ``csrc/guided_decode.cu``),
``fused_resblock`` and ``fused_resblock_split`` those of the UNet
residual-block kernel (``ops/resblock.py``, ``csrc/fused_resblock.cu``), and
``single_block_attention`` and ``single_block_attention_bwd`` those of the
single-block attention pair (``ops/single_block.py``,
``csrc/attention_single_block.cu``).
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
    head_offset: int = 0,
    total_heads: int | None = None,
    batch_offset: int = 0,
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
    On a slice of a layer's heads (a tensor-parallel rank's), heads
    ``head_offset`` on of ``total_heads`` (default: the operands' H), the
    mask hashes the layer's head, ``b * total_heads + head_offset + h``;
    on rows ``batch_offset`` on of a global batch (a data-parallel rank's),
    ``b`` counts from there.
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
        bh = _hashed_heads(b, h, head_offset, total_heads, q.device,
                           batch_offset)
        weights = weights * dropout_scale(
            dropout_seed, bh, q_pos[:, None], k_pos[None, :], dropout_rate
        )
    out = torch.matmul(weights, v.float()).to(q.dtype)
    if layout == "blhd":
        out = out.transpose(1, 2)
    return out, lse


def masked_attention(q, k, v, mask, *, layout: str = "bhld",
                     dropout_rate: float = 0.0, dropout_key=None):
    """Attention under an arbitrary boolean ``mask`` (broadcastable to (B,
    H, Lq, Lk), True = keep), as the JAX package's ``xla_ref.attention``
    computes it, which takes every masked call: float32 scores over
    sqrt(Dh), masked scores at float32's lowest value, the softmax, then
    (``dropout_rate`` > 0) the weights' dropout from ``dropout_key`` by
    ``draw_keep`` over (B, H, Lq, Lk) in either layout (``ops.rng.dropout``:
    the draw kernel on the card), the weights in v's dtype times v. Plain
    PyTorch on both devices: the flash kernels take no arbitrary mask."""
    from tinydiffusionmodels_torch.ops import rng as rng_ops

    if layout not in LAYOUTS:
        raise ValueError(f"unknown attention layout: {layout!r}")
    if dropout_rate > 0.0 and dropout_key is None:
        raise ValueError("dropout_rate > 0 requires dropout_key")
    if layout == "blhd":
        q, k, v = (a.transpose(1, 2) for a in (q, k, v))
    scale = torch.tensor(q.shape[-1], dtype=torch.float32).sqrt()
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / scale
    scores = torch.where(torch.as_tensor(mask, device=scores.device), scores,
                         torch.finfo(torch.float32).min)
    weights = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0:
        weights = rng_ops.dropout(weights.contiguous(), dropout_key,
                                  dropout_rate)
    out = torch.matmul(weights.to(v.dtype), v)
    return out.transpose(1, 2) if layout == "blhd" else out


def _hashed_heads(b: int, h: int, head_offset: int, total_heads, device,
                  batch_offset: int = 0):
    """(B, H, 1, 1) head indices the dropout mask hashes:
    ``(batch_offset + b) * total_heads + head_offset + h`` (``b * H + h``
    by default)."""
    total = h if total_heads is None else total_heads
    if head_offset < 0 or total < head_offset + h:
        raise ValueError(f"heads {head_offset}..{head_offset + h} are not "
                         f"among {total}")
    if batch_offset < 0:
        raise ValueError(f"batch offset {batch_offset} < 0")
    rows = torch.arange(batch_offset, batch_offset + b, device=device)
    return (rows.reshape(b, 1, 1, 1) * total
            + head_offset + torch.arange(h, device=device).reshape(1, h, 1, 1))


def _bwd_probs(q, k, lse, *, causal, q_offset, k_offset):
    """The backward kernels' recompute of P from (B, H, L, D) operands: the
    forward's scores (the causal mask at float32's lowest value) and
    P = exp(S - lse); also the keep predicate (None when not causal) and
    the positions."""
    lq, lk = q.shape[-2], k.shape[-2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(
        q.shape[-1])
    q_pos = q_offset + torch.arange(lq, device=q.device)
    k_pos = k_offset + torch.arange(lk, device=q.device)
    keep = None
    if causal:
        keep = q_pos[:, None] >= k_pos[None, :]
        s = s.masked_fill(~keep, torch.finfo(torch.float32).min)
    return torch.exp(s - lse[..., None]), keep, q_pos, k_pos


def _attention_bwd(q, k, v, g_out, lse, delta, *, causal, layout, q_offset,
                   k_offset, dropout_rate, dropout_seed, want, head_offset=0,
                   total_heads=None, batch_offset=0):
    """dq (``want`` 'dq') or (dk, dv) ('dkv') of ``attention`` as the flash
    backward kernels compute them: P recomputed from q, k and the forward's
    lse, dP = (dO V^T) * mask, dS = P (dP - D) zeroed where the causal
    predicate masks a key, with D = ``delta`` (rowsum(dO O) - the lse
    cotangent, from the forward's stored output); every product in float32,
    each gradient in its operand's dtype and layout."""
    if layout == "blhd":
        q, k, v, g_out = (a.transpose(1, 2) for a in (q, k, v, g_out))
    b, h = q.shape[:2]
    p, keep, q_pos, k_pos = _bwd_probs(q, k, lse, causal=causal,
                                       q_offset=q_offset, k_offset=k_offset)
    mask = None
    if dropout_rate > 0.0:
        bh = _hashed_heads(b, h, head_offset, total_heads, q.device,
                           batch_offset)
        mask = dropout_scale(dropout_seed, bh, q_pos[:, None],
                             k_pos[None, :], dropout_rate)
    g = g_out.float()
    dp = torch.matmul(g, v.float().transpose(-1, -2))
    if mask is not None:
        dp = dp * mask
    ds = p * (dp - delta[..., None])
    if keep is not None:
        ds = ds.masked_fill(~keep, 0.0)
    scale = 1.0 / math.sqrt(q.shape[-1])
    if want == "dq":
        grads = (torch.matmul(ds, k.float()) * scale).to(q.dtype),
    else:
        w = p if mask is None else p * mask
        grads = ((torch.matmul(ds.transpose(-1, -2), q.float()) * scale).to(
            k.dtype), torch.matmul(w.transpose(-1, -2), g).to(v.dtype))
    if layout == "blhd":
        grads = tuple(x.transpose(1, 2) for x in grads)
    return grads


def attention_bwd_dq(q, k, v, g_out, lse, delta, **params) -> torch.Tensor:
    """Plain version of the flash dq kernel (``pallas_kernels.
    _flash_dq_kernel``): dq from q, k, v, the output cotangent ``g_out``,
    the forward's (B, H, Lq) float32 ``lse`` and ``delta`` (D), with
    ``attention``'s keyword arguments."""
    return _attention_bwd(q, k, v, g_out, lse, delta, want="dq", **params)[0]


def attention_bwd_dkv(q, k, v, g_out, lse, delta, **params):
    """Plain version of the flash dk/dv kernel (``pallas_kernels.
    _flash_dkv_kernel``): (dk, dv), as ``attention_bwd_dq``."""
    return _attention_bwd(q, k, v, g_out, lse, delta, want="dkv", **params)


def _single_block_probs(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(Dh)) in float32, as the TPU kernels form it:
    float32 scores times the scale, max-subtracted exp, normalised."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s * (1.0 / math.sqrt(q.shape[-1]))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to ``dtype`` and widened back to float32."""
    return x.to(dtype).float()


def single_block_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """Plain version of the single-block attention kernel
    (``pallas_kernels._attention_kernel``): softmax(q k^T / sqrt(Dh)) v over
    (B, H, L, Dh) tensors, no mask, no dropout. The normalised weights are
    rounded to v's dtype before P V, which sums in float32; the output takes
    q's dtype. In bfloat16 this differs from ``attention``, whose P V
    multiplies float32 weights."""
    p = _single_block_probs(q, k)
    return torch.matmul(_rounded(p, v.dtype), v.float()).to(q.dtype)


def single_block_attention_bwd(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, g: torch.Tensor):
    """Plain version of the single-block recompute backward
    (``pallas_kernels._attention_bwd_kernel``): (dq, dk, dv) for the output
    cotangent ``g``, in q's dtype. It recomputes p from q and k alone,
    takes D = rowsum(g O) of the recomputed float32 O = round(p) v (not the
    forward's stored output) as rowsum(round(p) dp), which needs no O, and
    rounds ds to k's and q's dtype and p to g's dtype before the three
    products, as the TPU kernel does. Written out, not autograd of the
    forward, because autograd would not round ds."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = _single_block_probs(q, k)
    dp = torch.matmul(g.float(), v.float().transpose(-1, -2))
    d = (_rounded(p, v.dtype) * dp).sum(-1, keepdim=True)
    ds = p * (dp - d)
    dq = torch.matmul(_rounded(ds, k.dtype), k.float()) * scale
    dk = torch.matmul(_rounded(ds, q.dtype).transpose(-1, -2), q.float())
    dv = torch.matmul(_rounded(p, g.dtype).transpose(-1, -2), g.float())
    return dq.to(q.dtype), (dk * scale).to(q.dtype), dv.to(q.dtype)


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


def _resblock(x, w1, b1, w2, b2, time_bias, ws, bs, round_h=None):
    """The block's arithmetic in its operands' dtype; ``round_h`` rounds h
    to that dtype (and back to float32) before conv2."""
    xc = x.permute(0, 3, 1, 2)
    h = F.relu(F.conv2d(xc, w1, b1, padding=1))
    h = h + time_bias.permute(0, 3, 1, 2)
    if round_h is not None:
        h = h.to(round_h).float()
    h = F.relu(F.conv2d(h, w2, b2, padding=1))
    skip = xc if ws is None else F.conv2d(xc, ws, bs)
    return (h + skip).permute(0, 2, 3, 1)


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
    re-zeroed border gives it. Full float32 on every device. bfloat16
    arguments are computed as the TPU kernel computes them: float32 convs of
    the bfloat16 values, h rounded to bfloat16 before conv2, the output
    rounded to bfloat16."""
    dtype = x.dtype
    args = (x, w1, b1, w2, b2, time_bias, ws, bs)
    if dtype == torch.bfloat16:
        args = (None if t is None else t.float() for t in args)
    with full_f32_convs():
        return _resblock(*args, round_h=dtype if dtype == torch.bfloat16
                         else None).to(dtype)


def resblock_in_dtype(x, w1, b1, w2, b2, time_bias, ws=None, bs=None):
    """The block computed in its operands' dtype, as ``xla_ref.
    fused_resblock`` computes it: what the kernel's backward differentiates
    (``jax.vjp(xla_ref.fused_resblock, ...)`` in the JAX package), so bf16
    operands get bf16 convolutions and bf16 gradients. Float32 convolutions
    in full float32. In float32 it is ``fused_resblock``."""
    with full_f32_convs():
        return _resblock(x, w1, b1, w2, b2, time_bias, ws, bs)


def upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-neighbour upsampling of NHWC ``x`` by an integer factor:
    pixel (y, x) of the output is pixel (y // factor, x // factor)."""
    if factor == 1:
        return x
    return x.repeat_interleave(factor, dim=1).repeat_interleave(factor,
                                                                dim=2)


def concat_sources(x_a: torch.Tensor, x_b: torch.Tensor,
                   upsample_a: int = 1) -> torch.Tensor:
    """The input of a two-source block: cat(upsample_nearest(x_a,
    upsample_a), x_b) along channels."""
    return torch.cat([upsample_nearest(x_a, upsample_a), x_b], dim=-1)


def fused_resblock_split(x_a, x_b, w1, b1, w2, b2, time_bias, ws=None,
                         bs=None, *, upsample_a: int = 1):
    """Plain version of the two-source block (``xla_ref.
    fused_resblock_split``, with x_a upsampled first): ``fused_resblock``
    on ``concat_sources(x_a, x_b, upsample_a)``. The kernel reads the two
    sources into the rows the concatenated tile fills; this builds it."""
    return fused_resblock(concat_sources(x_a, x_b, upsample_a), w1, b1, w2,
                          b2, time_bias, ws, bs)
