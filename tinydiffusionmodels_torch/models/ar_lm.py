"""TinyGPT: the small causal LM of guided sampling (port of
``models/ar_lm.py``).

A pre-LN GPT (learned positions, fused QKV, tanh-GELU MLP, LayerNorm eps
1e-5, a bias-free LM head) that the guided sampler uses as its base LM when
no Hugging Face LM loads, with KV-cached single-token decoding so a guided
decode costs one decode step per token instead of one full forward per
prefix (reference src/shakespeare.py:445-470).

Parameter names follow the JAX parameter tree (``tok_emb``, ``pos_emb``,
``blocks.N.{ln1,attn.qkv,attn.proj,ln2,mlp.fc,mlp.proj}``, ``ln_f``,
``lm_head``); ``io.convert.tiny_gpt_state_from_jax`` maps one onto the other.
Attention goes through ``ops.attention`` in the copy-free (B, L, H, Dh)
layout: the CUDA flash kernels on the card, their plain version on the CPU.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from tinydiffusionmodels_torch import ops
from tinydiffusionmodels_torch.io import convert
from tinydiffusionmodels_torch.models import init


@dataclasses.dataclass(frozen=True)
class TinyGPTConfig:
    vocab_size: int
    dim: int = 256
    n_heads: int = 4
    depth: int = 4
    max_len: int = 256
    ffn_mult: int = 4


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (torch's default
    is the erf form)."""
    return F.gelu(x, approximate="tanh")


def _linear(in_dim: int, out_dim: int, bias: bool = True) -> nn.Linear:
    return nn.utils.skip_init(nn.Linear, in_dim, out_dim, bias=bias)


class Block(nn.Module):
    """Pre-LN GPT block: x + attn(ln1(x)), then x + mlp(ln2(x))."""

    def __init__(self, cfg: TinyGPTConfig):
        super().__init__()
        d = cfg.dim
        self.cfg = cfg
        self.ln1 = nn.LayerNorm(d, eps=1e-5)
        self.attn = nn.ModuleDict({"qkv": _linear(d, 3 * d),
                                   "proj": _linear(d, d)})
        self.ln2 = nn.LayerNorm(d, eps=1e-5)
        self.mlp = nn.ModuleDict({"fc": _linear(d, cfg.ffn_mult * d),
                                  "proj": _linear(cfg.ffn_mult * d, d)})

    def qkv(self, x: torch.Tensor):
        """(B, L, D) -> q, k, v as (B, L, H, Dh) views of one projection."""
        b, l, d = x.shape
        qkv = self.attn["qkv"](self.ln1(x))
        return (a.reshape(b, l, self.cfg.n_heads, d // self.cfg.n_heads)
                for a in qkv.split(d, dim=-1))

    def finish(self, x: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
        """The residual adds after attention: projection, then the MLP."""
        b, l, d = x.shape
        x = x + self.attn["proj"](attn.reshape(b, l, d))
        return x + self.mlp["proj"](gelu_tanh(self.mlp["fc"](self.ln2(x))))


class TinyGPT(nn.Module):
    """ids (B, L) -> next-token logits (B, L, V). The weights are
    ``init_tiny_gpt``'s from ``key``, drawn on ``device``."""

    def __init__(self, cfg: TinyGPTConfig, *, key=None, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.dim
        self.tok_emb = nn.Embedding(cfg.vocab_size, d,
                                    _weight=torch.empty(cfg.vocab_size, d))
        self.pos_emb = nn.Embedding(cfg.max_len, d,
                                    _weight=torch.empty(cfg.max_len, d))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.ln_f = nn.LayerNorm(d, eps=1e-5)
        self.lm_head = _linear(d, cfg.vocab_size, bias=False)
        self.to(device)
        self.reset_parameters(key)

    def reset_parameters(self, key=None) -> None:
        """The JAX package's ``init_tiny_gpt`` from ``key`` (``PRNGKey(0)``
        when None), drawn on the parameters' device: token table 0.02
        N(0, 1), position table 0.01 N(0, 1), linears U(+-1/sqrt(fan_in)),
        LayerNorms 1/0."""
        # nn.utils.skip_init builds a module to load into: no draw.
        if self.lm_head.weight.is_meta:
            return
        params = init.init_tiny_gpt(init.default_key(key), self.cfg,
                                    self.lm_head.weight.device)
        self.load_state_dict(convert.tiny_gpt_state_from_jax(params))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        """Full causal forward (``tiny_gpt_apply``)."""
        l = ids.shape[1]
        x = self.tok_emb(ids) + self.pos_emb.weight[:l]
        for blk in self.blocks:
            q, k, v = blk.qkv(x)
            x = blk.finish(x, ops.attention(q, k, v, causal=True,
                                            layout="blhd"))
        return self.lm_head(self.ln_f(x))

    def init_cache(self, batch: int) -> dict:
        """KV cache: (depth, B, max_len, H, Dh) k and v in BLHD (time-major)
        layout, zero-filled, in the parameters' dtype and on their device
        (bf16 for a bf16 copy of the model), plus the position as a Python
        int, so a decode loop never reads the device."""
        cfg = self.cfg
        w = self.tok_emb.weight
        shape = (cfg.depth, batch, cfg.max_len, cfg.n_heads,
                 cfg.dim // cfg.n_heads)
        return {"k": torch.zeros(shape, dtype=w.dtype, device=w.device),
                "v": torch.zeros(shape, dtype=w.dtype, device=w.device),
                "pos": 0}

    def decode_step(self, cache: dict, token: torch.Tensor,
                    attn_len: int | None = None):
        """One KV-cached decode step (``tiny_gpt_decode_step``): token (B,)
        -> (logits (B, V), cache).

        The cache's k and v are updated in place at slot ``pos`` and the
        returned dict carries ``pos + 1``. Attention reads the filled prefix
        ``[:pos + 1]`` as a strided view: the JAX step's masked slots get
        probability exactly 0, so this is the same function. ``attn_len``
        (the JAX step's static window, ``sample.guided``'s segments) only
        bounds ``pos``."""
        pos = cache["pos"]
        limit = self.cfg.max_len if attn_len is None else attn_len
        if pos >= limit:
            raise ValueError(f"decode position {pos} is past the attention "
                             f"window {limit}")
        k_all, v_all = cache["k"], cache["v"]
        x = self.tok_emb(token)[:, None, :] + self.pos_emb.weight[pos]
        for i, blk in enumerate(self.blocks):
            q, k, v = blk.qkv(x)
            k_all[i, :, pos] = k[:, 0]
            v_all[i, :, pos] = v[:, 0]
            attn = ops.attention(q, k_all[i, :, :pos + 1],
                                 v_all[i, :, :pos + 1], layout="blhd")
            x = blk.finish(x, attn)
        logits = self.lm_head(self.ln_f(x))[:, 0, :]
        return logits, {"k": k_all, "v": v_all, "pos": pos + 1}
