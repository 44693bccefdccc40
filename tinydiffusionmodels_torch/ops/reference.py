"""Plain PyTorch attention: the semantics contract of the flash kernels.

Port of ``ops/xla_ref.attention`` (the JAX package's plain version), widened
to what the flash kernels compute: the output and the per-row float32
logsumexp, an optional causal predicate on global positions, values whose
width may differ from the keys', and the TPU flash kernel's attention-weight
dropout with its coordinate-hash mask (``dropout_scale``). The CPU tests and
the CPU path of the models run this, forward and (by autograd) backward;
``chip_smoke.py`` holds the CUDA kernels against it on the card.
"""

from __future__ import annotations

import math

import torch

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
