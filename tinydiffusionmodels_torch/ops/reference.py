"""Plain PyTorch attention: the semantics contract of the flash kernel.

Port of ``ops/xla_ref.attention`` (the JAX package's plain version), widened
to what the flash kernel computes: the output and the per-row float32
logsumexp, an optional causal predicate on global positions, and values whose
width may differ from the keys'. The CPU tests and the CPU path of the models
run this; ``chip_smoke.py`` holds the CUDA kernel against it on the card.
"""

from __future__ import annotations

import math

import torch

LAYOUTS = ("bhld", "blhd")


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    layout: str = "bhld",
    q_offset: int = 0,
    k_offset: int = 0,
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
    """
    if layout not in LAYOUTS:
        raise ValueError(f"unknown attention layout: {layout!r}")
    if layout == "blhd":
        q, k, v = (a.transpose(1, 2) for a in (q, k, v))
    lq, dh = q.shape[-2], q.shape[-1]
    lk = k.shape[-2]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(dh)
    if causal:
        q_pos = q_offset + torch.arange(lq, device=q.device)
        k_pos = k_offset + torch.arange(lk, device=q.device)
        keep = q_pos[:, None] >= k_pos[None, :]
        scores = scores.masked_fill(~keep, torch.finfo(torch.float32).min)
    lse = torch.logsumexp(scores, dim=-1)
    weights = torch.softmax(scores, dim=-1)
    out = torch.matmul(weights, v.float()).to(q.dtype)
    if layout == "blhd":
        out = out.transpose(1, 2)
    return out, lse
