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

Sequence parallelism (``cfg.seq_axis``): the model is called on this
rank's shard of the sequence, attention is the ring over the axis's
registered mesh (``ops.attention``), and positions are global: the rotary
angles and the absolute table start at the shard's offset, and each
dropout mask is drawn for the whole sequence and cut to the shard, so a
ring drops what one device drops for the same generator. (The JAX package
gets global positions from GSPMD's global arrays.)

Tensor parallelism (``parallel.tp.shard_transformer``): a layer whose
``tp`` is set holds its rank's heads of the attention and columns of the
FFN, runs the Megatron column and row products with their all-reduces,
draws every dropout mask at the whole layer's width (the FFN's feature
mask cut to its columns) and hashes the layer's head index in the
attention kernels, so it computes what one device computes. ``tp`` is
None on one device.
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
from tinydiffusionmodels_torch.parallel.tp import (
    copy_to_model,
    reduce_from_model,
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
    # Sequence-parallel: route attention through the ring over this axis
    # (ops.register_sequence_mesh must have registered it); the model then
    # takes this rank's shard of the sequence. None = single device.
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
    x: torch.Tensor, rate: float, generator: torch.Generator | None,
    shard: tuple[int, int] = (0, 1), features: tuple[int, int] = (0, 1),
) -> torch.Tensor:
    """Inverted dropout with torch nn.Dropout semantics (JAX:
    ``torch_init.dropout``), its mask drawn from ``generator``; no generator
    (eval mode) or rate 0 returns ``x``. ``shard`` = (index, n): ``x`` is
    shard ``index`` of n along dim 1 (a sequence ring), and the mask is
    drawn for all n shards and cut to this one; ``features`` the same along
    the last dim (a tensor-parallel rank's columns)."""
    if generator is None or rate == 0.0:
        return x
    (index, n), (col, cols) = shard, features
    if n == 1 and cols == 1:
        keep = torch.empty_like(x).bernoulli_(1.0 - rate, generator=generator)
    else:
        shape = list(x.shape)
        shape[1] *= n
        shape[-1] *= cols
        keep = torch.empty(shape, dtype=x.dtype, device=x.device).bernoulli_(
            1.0 - rate, generator=generator).narrow(
                1, index * x.shape[1], x.shape[1]).narrow(
                    -1, col * x.shape[-1], x.shape[-1])
    return x * keep / (1.0 - rate)


def _rope(x: torch.Tensor, base: float = 10000.0, *, l_axis: int = 2,
          offset: int = 0):
    """Rotary position embedding over axis ``l_axis`` (2 for (B, H, L, Dh),
    1 for (B, L, H, Dh)), the rows at global positions ``offset`` on; same
    float32 formulas as the JAX package."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = base ** (
        -torch.arange(half, dtype=torch.float32, device=x.device) / half
    )
    pos = torch.arange(offset, offset + x.shape[l_axis], dtype=torch.float32,
                       device=x.device)
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
        self.tp = None   # parallel.tp.TensorSplit: this rank's heads

    def forward(
        self, x: torch.Tensor, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        """``generator`` (training) seeds the attention-weight dropout."""
        cfg, tp = self.cfg, self.tp
        b, l, d = x.shape
        dh = d // cfg.n_heads
        heads, heads_kw = cfg.n_heads, {}
        if tp is not None:
            heads = cfg.n_heads // tp.size
            heads_kw = dict(head_offset=tp.index * heads,
                            total_heads=cfg.n_heads)
            x = copy_to_model(x, tp)
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = (
            a.reshape(b, l, heads, dh) for a in qkv.split(heads * dh, dim=-1)
        )
        if cfg.pos_kind == "rope":
            offset = ops.sequence_shard(cfg.seq_axis)[0] * l
            q = _rope(q, l_axis=1, offset=offset)
            k = _rope(k, l_axis=1, offset=offset)
        rate, seed = 0.0, None
        if generator is not None and cfg.dropout > 0.0:
            # One int32 seed per call, drawn on the device: the kernels read
            # it there, as the TPU kernel reads its SMEM scalar.
            rate = cfg.dropout
            seed = torch.randint(-2**31, 2**31, (1,), generator=generator,
                                 device=x.device, dtype=torch.int32)
        out = ops.attention(q, k, v, layout="blhd", dropout_rate=rate,
                            dropout_seed=seed, seq_axis=cfg.seq_axis,
                            **heads_kw)
        out = out.reshape(b, l, heads * dh)
        if tp is None:
            return self.out_proj(out)
        # Row-parallel: the partial products summed, the bias added once.
        return reduce_from_model(F.linear(out, self.out_proj.weight),
                                 tp) + self.out_proj.bias


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
        self.seq_axis = cfg.seq_axis
        self.tp = None   # parallel.tp.TensorSplit: this rank's FFN columns

    def forward(
        self, x: torch.Tensor, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        """``generator`` (training) draws the dropout masks: dropout1 on the
        attention output, dropout_ffn after the ReLU, dropout2 after
        linear2."""
        g, rate, tp = generator, self.rate, self.tp
        shard = ops.sequence_shard(self.seq_axis)
        sa = dropout(self.self_attn(x, g), rate, g, shard)
        x = self.norm1(x + sa)
        if tp is None:
            ff = dropout(F.relu(self.linear1(x)), rate, g, shard)
            ff = dropout(self.linear2(ff), rate, g, shard)
        else:
            ff = dropout(F.relu(self.linear1(copy_to_model(x, tp))), rate, g,
                         shard, features=(tp.index, tp.size))
            ff = reduce_from_model(F.linear(ff, self.linear2.weight),
                                   tp) + self.linear2.bias
            ff = dropout(ff, rate, g, shard)
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
        shard = ops.sequence_shard(cfg.seq_axis)
        t_scaled = (t.to(x.dtype) / cfg.timesteps)[:, None]      # (B, 1)
        x = x + self.time_emb(t_scaled)[:, None, :]
        if self.pos_emb is not None:
            table = self.pos_emb.weight
            start = shard[0] * x.shape[1]
            if shard[1] * x.shape[1] > table.shape[0]:
                raise ValueError(
                    f"seq_len {shard[1] * x.shape[1]} exceeds the "
                    "absolute-position "
                    f"table trained for max_len={table.shape[0]}; sample "
                    "with a shorter --seq_len, or train with --pos_emb rope "
                    "for length extrapolation"
                )
            x = x + table[start:start + x.shape[1]][None].to(x.dtype)
        if cfg.self_cond:
            if x0_prev is not None:
                x = x + self.selfcond_proj(x0_prev.to(x.dtype))
        elif x0_prev is not None:
            raise ValueError("x0_prev passed but cfg.self_cond is False")
        x = dropout(x, cfg.dropout, g, shard)
        for layer in self.encoder.layers:
            x = layer(x, g)
        return x
