"""TinyTransformer: the eps-prediction denoiser for text diffusion (port of
``models/transformer.py``).

The reference's torch nn.TransformerEncoder (post-LN, ReLU feed-forward of
width 2048, 4 heads) with its time bias Linear(1, dim) of t/T, plus the JAX
package's extensions: learned absolute or rotary positions and
self-conditioning. The encoder layer is written out instead of using
nn.TransformerEncoderLayer / nn.MultiheadAttention, so attention goes
through ``ops.attention`` (the CUDA flash kernel on the card). Parameter
names are the reference state dict's (``encoder.layers.N.self_attn.
in_proj_weight`` ...), so a checkpoint the JAX CLI wrote loads with
``load_state_dict(strict=True)``.

Training mode (``deterministic=False``) applies dropout at the JAX
package's sites: the input, the attention weights (inside the flash kernels,
seeded per layer), and ``dropout1``, ``dropout_ffn`` and ``dropout2`` of
every layer. Every mask and seed is drawn from the ``torch.Generator`` the
caller passes, on the model's device, so a training step needs no host sync.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from tinydiffusionmodels_torch import ops
from tinydiffusionmodels_torch.models.embedding import (
    _default_generator,
    init_linear_,
)

# torch nn.TransformerEncoderLayer default feed-forward width.
FFN_DIM = 2048


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    dim: int
    n_heads: int = 4
    depth: int = 3
    dropout: float = 0.1
    ffn_dim: int = FFN_DIM
    timesteps: int = 1000
    # Sequence-parallel ring axis: not ported; ops.attention raises if set.
    seq_axis: str | None = None
    # 'none' (reference), 'abs' (learned absolute table) or 'rope' (rotary);
    # bool True is accepted as 'abs'.
    pos_emb: str | bool = "none"
    max_len: int = 512
    self_cond: bool = False

    @property
    def pos_kind(self) -> str:
        if self.pos_emb is True:
            return "abs"
        if self.pos_emb in (False, None):
            return "none"
        return self.pos_emb


def _linear(in_dim: int, out_dim: int) -> nn.Linear:
    # skip_init: parameters are drawn by reset_parameters from an explicit
    # generator, not by nn.Linear from the global RNG.
    return nn.utils.skip_init(nn.Linear, in_dim, out_dim)


def dropout(
    x: torch.Tensor, rate: float, generator: torch.Generator | None
) -> torch.Tensor:
    """Inverted dropout with torch nn.Dropout semantics (JAX:
    ``torch_init.dropout``), its mask drawn from ``generator``; no generator
    (eval mode) or rate 0 returns ``x``."""
    if generator is None or rate == 0.0:
        return x
    keep = torch.empty_like(x).bernoulli_(1.0 - rate, generator=generator)
    return x * keep / (1.0 - rate)


def _rope(x: torch.Tensor, base: float = 10000.0, *, l_axis: int = 2):
    """Rotary position embedding over axis ``l_axis`` (2 for (B, H, L, Dh),
    1 for (B, L, H, Dh)); same float32 formulas as the JAX package."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = base ** (
        -torch.arange(half, dtype=torch.float32, device=x.device) / half
    )
    pos = torch.arange(x.shape[l_axis], dtype=torch.float32, device=x.device)
    ang = pos[:, None] * freqs[None, :]                      # (L, half)
    cos = torch.cos(ang).to(x.dtype)
    sin = torch.sin(ang).to(x.dtype)
    if l_axis == 1:
        cos, sin = cos[:, None, :], sin[:, None, :]          # (L, 1, half)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


class SelfAttention(nn.Module):
    """nn.MultiheadAttention's parameters (fused in_proj, out_proj), with
    attention through ``ops.attention`` in the copy-free (B, L, H, Dh)
    layout: the head split after the fused QKV projection is a view."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        d = cfg.dim
        self.cfg = cfg
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d))
        self.out_proj = _linear(d, d)

    def forward(
        self, x: torch.Tensor, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        """``generator`` (training) seeds the attention-weight dropout."""
        cfg = self.cfg
        b, l, d = x.shape
        dh = d // cfg.n_heads
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = (
            a.reshape(b, l, cfg.n_heads, dh) for a in qkv.split(d, dim=-1)
        )
        if cfg.pos_kind == "rope":
            q, k = _rope(q, l_axis=1), _rope(k, l_axis=1)
        rate, seed = 0.0, None
        if generator is not None and cfg.dropout > 0.0:
            # One int32 seed per call, drawn on the device: the kernels read
            # it there, as the TPU kernel reads its SMEM scalar.
            rate = cfg.dropout
            seed = torch.randint(-2**31, 2**31, (1,), generator=generator,
                                 device=x.device, dtype=torch.int32)
        out = ops.attention(q, k, v, layout="blhd", dropout_rate=rate,
                            dropout_seed=seed, seq_axis=cfg.seq_axis)
        return self.out_proj(out.reshape(b, l, d))


class EncoderLayer(nn.Module):
    """Post-LN torch TransformerEncoderLayer (norm_first=False, relu)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.self_attn = SelfAttention(cfg)
        self.linear1 = _linear(cfg.dim, cfg.ffn_dim)
        self.linear2 = _linear(cfg.ffn_dim, cfg.dim)
        self.norm1 = nn.LayerNorm(cfg.dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(cfg.dim, eps=1e-5)
        self.rate = cfg.dropout

    def forward(
        self, x: torch.Tensor, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        """``generator`` (training) draws the dropout masks: dropout1 on the
        attention output, dropout_ffn after the ReLU, dropout2 after
        linear2."""
        g, rate = generator, self.rate
        sa = dropout(self.self_attn(x, g), rate, g)
        x = self.norm1(x + sa)
        ff = dropout(F.relu(self.linear1(x)), rate, g)
        ff = dropout(self.linear2(ff), rate, g)
        return self.norm2(x + ff)


class Encoder(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.depth))


class TinyTransformer(nn.Module):
    """x: (B, L, dim) noisy embeddings, t: (B,) int timesteps -> eps_hat
    (or x0_hat for an x0-parameterized checkpoint)."""

    def __init__(
        self,
        cfg: TransformerConfig,
        *,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.cfg = cfg
        self.time_emb = _linear(1, cfg.dim)
        if cfg.pos_kind == "abs":
            self.pos_emb = nn.Embedding(
                cfg.max_len, cfg.dim, _weight=torch.empty(cfg.max_len, cfg.dim)
            )
        else:
            self.pos_emb = None
        self.selfcond_proj = _linear(cfg.dim, cfg.dim) if cfg.self_cond else None
        self.encoder = Encoder(cfg)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """torch's module defaults, drawn from ``generator`` (seed 0 when
        None): nn.Linear U(+-1/sqrt(fan_in)); MHA xavier-uniform in_proj with
        zero in_proj and out_proj biases; LayerNorm 1/0; the position table
        N(0, 0.02); the self-conditioning projection zero (so with no
        estimate the model computes the unconditioned function)."""
        g = _default_generator(generator)
        d = self.cfg.dim
        with torch.no_grad():
            init_linear_(self.time_emb, g)
            if self.pos_emb is not None:
                self.pos_emb.weight.normal_(0.0, 0.02, generator=g)
            if self.selfcond_proj is not None:
                self.selfcond_proj.weight.zero_()
                self.selfcond_proj.bias.zero_()
            for layer in self.encoder.layers:
                attn = layer.self_attn
                bound = math.sqrt(6.0 / (d + 3 * d))
                attn.in_proj_weight.uniform_(-bound, bound, generator=g)
                attn.in_proj_bias.zero_()
                init_linear_(attn.out_proj, g)
                attn.out_proj.bias.zero_()
                init_linear_(layer.linear1, g)
                init_linear_(layer.linear2, g)
                for norm in (layer.norm1, layer.norm2):
                    norm.reset_parameters()

    def forward(
        self,
        x: torch.Tensor,
        t: torch.Tensor,
        *,
        x0_prev: torch.Tensor | None = None,
        deterministic: bool = True,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """Additive time bias (and positions, and the self-conditioning
        input), input dropout, then the encoder stack. ``x0_prev`` is the
        previous clean estimate when ``cfg.self_cond``; None means no
        estimate. ``deterministic=False`` (training) needs ``generator``, on
        the device of ``x``, for every dropout mask and seed."""
        cfg = self.cfg
        if not deterministic and generator is None:
            raise ValueError("training mode requires a torch.Generator")
        g = None if deterministic else generator
        t_scaled = (t.to(x.dtype) / cfg.timesteps)[:, None]      # (B, 1)
        x = x + self.time_emb(t_scaled)[:, None, :]
        if self.pos_emb is not None:
            table = self.pos_emb.weight
            if x.shape[1] > table.shape[0]:
                raise ValueError(
                    f"seq_len {x.shape[1]} exceeds the absolute-position "
                    f"table trained for max_len={table.shape[0]}; sample "
                    "with a shorter --seq_len, or train with --pos_emb rope "
                    "for length extrapolation"
                )
            x = x + table[: x.shape[1]][None].to(x.dtype)
        if cfg.self_cond:
            if x0_prev is not None:
                x = x + self.selfcond_proj(x0_prev.to(x.dtype))
        elif x0_prev is not None:
            raise ValueError("x0_prev passed but cfg.self_cond is False")
        x = dropout(x, cfg.dropout, g)
        for layer in self.encoder.layers:
            x = layer(x, g)
        return x
