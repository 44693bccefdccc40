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
package's sites, from the JAX package's keys (``core/rng.py``): the input
(``substream(key, "input_dropout")``), the attention weights (inside the
flash kernels, seeded per layer by ``randint(substream(fold_in(key, i),
"attn_weights"))``) and ``dropout1``, ``dropout_ffn`` and ``dropout2`` of
layer i (``substream(fold_in(key, i), name)``). Every mask and seed is
drawn on the model's device (``ops.rng``: on the card one launch a mask,
and one for all the layers' seeds, which the trainer draws with the
step's timesteps and noise), so a training step needs no host sync. The masks are ``draw_keep``'s, so
for the same key they equal the JAX package's; the attention-weight mask
is the flash kernels' coordinate hash, which equals the JAX package's
flash path (its XLA path, which it takes at the training shapes, drops a
``draw_keep`` mask of the weights instead).

Data parallelism (``batch_shard``, (index, count)): the model is called
on this rank's rows of the global batch, and every mask is those rows of
the global batch's (the flash kernels hash the rows' global index).

Sequence parallelism (``cfg.seq_axis``): the model is called on this
rank's shard of the sequence, attention is the ring over the axis's
registered mesh (``ops.attention``), and positions are global: the rotary
angles and the absolute table start at the shard's offset, and each
dropout mask is the shard's positions of the whole sequence's, so a
ring drops what one device drops for the same key. (The JAX package
gets global positions from GSPMD's global arrays.)

Tensor parallelism (``parallel.tp.shard_transformer``): a layer whose
``tp`` is set holds its rank's heads of the attention and columns of the
FFN, runs the Megatron column and row products with their all-reduces,
draws every dropout mask at the whole layer's width (the FFN's feature
mask drawn at its columns) and hashes the layer's head index in the
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
from tinydiffusionmodels_torch.core.rng import fold_in, substream
from tinydiffusionmodels_torch.io import convert
from tinydiffusionmodels_torch.models import init
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
    # skip_init: parameters are drawn by reset_parameters from the key
    # tree, not by nn.Linear from the global RNG.
    return nn.utils.skip_init(nn.Linear, in_dim, out_dim)


def dropout(
    x: torch.Tensor, rate: float, key, batch: tuple[int, int] = (0, 1),
    shard: tuple[int, int] = (0, 1), features: tuple[int, int] = (0, 1),
) -> torch.Tensor:
    """Inverted dropout with torch nn.Dropout semantics (JAX:
    ``torch_init.dropout``), its mask ``draw_keep(key, 1 - rate, shape)``
    (``ops.rng.dropout``); no key (eval mode) or rate 0 returns ``x``.
    ``batch``, ``shard`` and ``features`` = (index, n): ``x`` (B, L, D) is
    part ``index`` of n along the batch, the sequence (a ring) and the last
    dim (a tensor-parallel rank's columns), and its mask is that part of
    the whole (n B, n L, n D) mask."""
    if key is None or rate == 0.0:
        return x
    shape, window = [], []
    for size, (index, n) in zip(x.shape, (batch, shard, features)):
        shape.append(size * n)
        window.append((index * size, size))
    return ops.rng.dropout(x, key, rate, shape=shape, window=window)


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
        self, x: torch.Tensor, seed=None, batch: tuple[int, int] = (0, 1)
    ) -> torch.Tensor:
        """``seed`` (training: the layer's ``attention_seed``, a one-element
        int32 tensor on the device) seeds the attention-weight dropout;
        ``batch`` places ``x``'s rows in the global batch."""
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
        rate = 0.0 if seed is None else cfg.dropout
        out = ops.attention(q, k, v, layout="blhd", dropout_rate=rate,
                            dropout_seed=seed, seq_axis=cfg.seq_axis,
                            batch_offset=batch[0] * b, **heads_kw)
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
        self, x: torch.Tensor, key=None, batch: tuple[int, int] = (0, 1),
        seed=None,
    ) -> torch.Tensor:
        """``key`` (training; the layer's, ``fold_in(key, i)``) draws the
        dropout masks: dropout1 on the attention output, dropout_ffn after
        the ReLU, dropout2 after linear2; ``seed`` is the attention-weight
        dropout's (``TinyTransformer.seed_draws``). ``batch`` places
        ``x``'s rows in the global batch."""
        rate, tp = self.rate, self.tp
        shard = ops.sequence_shard(self.seq_axis)

        def drop(y, name, features=(0, 1)):
            if key is None:
                return y
            return dropout(y, rate, substream(key, name), batch, shard,
                           features)

        sa = drop(self.self_attn(x, seed, batch), "dropout1")
        x = self.norm1(x + sa)
        if tp is None:
            ff = drop(F.relu(self.linear1(x)), "dropout_ffn")
            ff = drop(self.linear2(ff), "dropout2")
        else:
            ff = drop(F.relu(self.linear1(copy_to_model(x, tp))),
                      "dropout_ffn", features=(tp.index, tp.size))
            ff = reduce_from_model(F.linear(ff, self.linear2.weight),
                                   tp) + self.linear2.bias
            ff = drop(ff, "dropout2")
        return self.norm2(x + ff)


class Encoder(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.depth))


class TinyTransformer(nn.Module):
    """x: (B, L, dim) noisy embeddings, t: (B,) int timesteps -> eps_hat
    (or x0_hat for an x0-parameterized checkpoint). The weights are
    ``init_tiny_transformer``'s from ``key``, drawn on ``device``."""

    def __init__(self, cfg: TransformerConfig, *, key=None, device=None):
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
        self.to(device)
        self.reset_parameters(key)

    def reset_parameters(self, key=None) -> None:
        """The JAX package's ``init_tiny_transformer`` from ``key``
        (``PRNGKey(0)`` when None), drawn on the parameters' device:
        torch's module defaults (nn.Linear U(+-1/sqrt(fan_in)); MHA
        xavier-uniform in_proj with zero in_proj and out_proj biases;
        LayerNorm 1/0), the position table 0.02 N(0, 1), the
        self-conditioning projection zero (so with no estimate the model
        computes the unconditioned function)."""
        # nn.utils.skip_init builds a module to load into: no draw.
        if self.time_emb.weight.is_meta:
            return
        params = init.init_tiny_transformer(
            init.default_key(key), self.cfg, self.time_emb.weight.device)
        self.load_state_dict(convert.transformer_state_from_jax(params))

    def forward(
        self,
        x: torch.Tensor,
        t: torch.Tensor,
        *,
        x0_prev: torch.Tensor | None = None,
        deterministic: bool = True,
        key=None,
        attn_seeds=None,
        batch_shard: tuple[int, int] = (0, 1),
    ) -> torch.Tensor:
        """Additive time bias (and positions, and the self-conditioning
        input), input dropout, then the encoder stack. ``x0_prev`` is the
        previous clean estimate when ``cfg.self_cond``; None means no
        estimate. ``deterministic=False`` (training) needs ``key`` (a key or
        ``core.rng.KeyPath`` on the device of ``x``: the JAX package's
        dropout key), from which every dropout mask and seed is drawn;
        ``attn_seeds`` are the layers' attention-weight seeds when the
        caller drew them (``seed_draws``, in its own launch), else they are
        drawn here in one. ``batch_shard`` = (index, n): ``x`` is the index-th of n equal row
        blocks of the global batch (a data-parallel rank's), and the masks
        are its rows of the global batch's."""
        cfg = self.cfg
        if not deterministic and key is None:
            raise ValueError("training mode requires a PRNG key")
        key = None if deterministic else key
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
        if key is not None:
            x = dropout(x, cfg.dropout, substream(key, "input_dropout"),
                        batch_shard, shard)
        if key is not None and attn_seeds is None:
            attn_seeds = ops.rng.draw_many(self.seed_draws(key), x.device)
        for i, layer in enumerate(self.encoder.layers):
            if key is None:
                x = layer(x, None, batch_shard)
            else:
                x = layer(x, fold_in(key, i), batch_shard,
                          attn_seeds[i] if attn_seeds else None)
        return x

    def seed_draws(self, key) -> list:
        """The layers' attention-weight dropout seeds under the dropout key
        ``key``, as ``ops.rng.Draw``s: layer i's is ``randint(substream(
        fold_in(key, i), "attn_weights"))``, the int32 scalar
        ``_pack_scalars`` draws, which the flash kernels read on the
        device; none without dropout."""
        if self.cfg.dropout == 0.0:
            return []
        return [ops.rng.attention_seed_draw(
            substream(fold_in(key, i), "attn_weights"))
            for i in range(self.cfg.depth)]
