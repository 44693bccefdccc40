"""Gemma (v1) causal LM, the guided sampler's Hugging Face base LM (port of
``models/gemma.py``).

The reference's guided sampler takes ``google/gemma-2b-it`` as its base LM
(reference src/shakespeare.py:482,509) and runs one full-prefix forward per
token. This module runs the same architecture natively on the card, with the
HF checkpoint's weights, and a KV-cached single-token decode step that drops
into ``sample.guided``'s decoder as TinyGPT's does.

Architecture (HF ``transformers.GemmaForCausalLM``):

- embeddings scaled by sqrt(hidden_size); the LM head tied to the embedding;
- RMSNorm with Gemma's ``(1 + weight)`` scale, computed in float32;
- rotary position embeddings (rotate-half convention, theta 10000), with
  the JAX module's ``inv_freq``;
- grouped-query attention (``num_kv_heads <= num_heads``), scale
  1/sqrt(head_dim);
- gated MLP ``down(gelu_tanh(gate(x)) * up(x))``.

Parameter names are HF's (``model.embed_tokens``, ``model.layers.N.
{input_layernorm, self_attn.{q,k,v,o}_proj, post_attention_layernorm,
mlp.{gate,up,down}_proj}``, ``model.norm``), so an HF state dict loads with
``load_hf_state_dict``, which checks and drops the tied ``lm_head.weight``.

Attention goes through ``ops.attention``: the CUDA flash forward on the
card, its plain version on the CPU. The kernel takes as many k and v heads
as q heads, so grouped heads are laid out for it without a new kernel:

- decode (one query row a head, no mask): the ``num_heads / num_kv_heads``
  query heads of a KV group become that group's query rows, so each KV head
  serves a (B, rows = group, KV, Dh) view against its (B, pos + 1, KV, Dh)
  cache prefix. Rows of one position are independent when nothing is
  masked, so this is the same function;
- the causal forward: k and v are expanded over the group. With one KV
  head that is a view whose head stride is 0; otherwise ``reshape`` copies.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from tinydiffusionmodels_torch import ops
from tinydiffusionmodels_torch.models.ar_lm import gelu_tanh


@dataclasses.dataclass(frozen=True)
class GemmaConfig:
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    intermediate_size: int
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    max_len: int = 512

    @classmethod
    def from_hf(cls, hf_config, max_len: int = 512) -> "GemmaConfig":
        """An HF ``GemmaConfig`` -> this config. Theta is read from
        ``rope_parameters`` (transformers 5) or ``rope_theta`` (4.x)."""
        rope = getattr(hf_config, "rope_parameters", None) or {}
        return cls(
            vocab_size=hf_config.vocab_size,
            hidden_size=hf_config.hidden_size,
            num_layers=hf_config.num_hidden_layers,
            num_heads=hf_config.num_attention_heads,
            num_kv_heads=hf_config.num_key_value_heads,
            head_dim=hf_config.head_dim,
            intermediate_size=hf_config.intermediate_size,
            rope_theta=rope.get("rope_theta",
                                getattr(hf_config, "rope_theta", 10000.0)),
            rms_eps=getattr(hf_config, "rms_norm_eps", 1e-6),
            max_len=max_len,
        )


class RMSNorm(nn.Module):
    """Gemma's RMSNorm: float32 compute, ``(1 + weight)`` scale, the input's
    dtype out."""

    def __init__(self, dim: int, eps: float, **factory):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.zeros(dim, **factory))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        normed = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + self.eps)
        return (normed * (1.0 + self.weight.float())).to(x.dtype)


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of the rotary angles, (L, head_dim) float32 with the two
    halves equal: ``inv_freq = theta ** (-arange(0, half) * 2 / head_dim)``
    in float32, as the JAX module computes it (HF's ``1 / theta **
    (arange(0, dim, 2) / dim)`` agrees up to rounding)."""
    half = head_dim // 2
    inv_freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                       device=positions.device)
                         * 2.0 / head_dim)
    angles = positions.float()[:, None] * inv_freq
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE of (B, L, heads, Dh) ``x`` at (L, Dh) ``cos`` and
    ``sin``: ``[x1 cos - x2 sin, x2 cos + x1 sin]`` in float32 (negation is
    exact, so ``x cos + rotate_half(x) sin`` gives the same bits), cast back
    to x's dtype."""
    xf = x.float()
    half = x.shape[-1] // 2
    rotated = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos[:, None] + rotated * sin[:, None]).to(x.dtype)


def _linear(in_dim: int, out_dim: int, factory: dict) -> nn.Linear:
    return nn.Linear(in_dim, out_dim, bias=False, **factory)


class GemmaLayer(nn.Module):
    """One decoder layer: x + o(attn(rope(q), rope(k), v)) of
    ``input_layernorm(x)``, then x + mlp(``post_attention_layernorm(x)``)."""

    def __init__(self, cfg: GemmaConfig, factory: dict):
        super().__init__()
        d, dh = cfg.hidden_size, cfg.head_dim
        self.cfg = cfg
        self.input_layernorm = RMSNorm(d, cfg.rms_eps, **factory)
        self.self_attn = nn.ModuleDict({
            "q_proj": _linear(d, cfg.num_heads * dh, factory),
            "k_proj": _linear(d, cfg.num_kv_heads * dh, factory),
            "v_proj": _linear(d, cfg.num_kv_heads * dh, factory),
            "o_proj": _linear(cfg.num_heads * dh, d, factory),
        })
        self.post_attention_layernorm = RMSNorm(d, cfg.rms_eps, **factory)
        self.mlp = nn.ModuleDict({
            "gate_proj": _linear(d, cfg.intermediate_size, factory),
            "up_proj": _linear(d, cfg.intermediate_size, factory),
            "down_proj": _linear(cfg.intermediate_size, d, factory),
        })

    def qkv(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
        """(B, L, D) -> q (B, L, H, Dh), k and v (B, L, KV, Dh), q and k
        rotated."""
        b, l, _ = x.shape
        cfg, attn = self.cfg, self.self_attn
        h = self.input_layernorm(x)
        q = attn["q_proj"](h).reshape(b, l, cfg.num_heads, cfg.head_dim)
        k = attn["k_proj"](h).reshape(b, l, cfg.num_kv_heads, cfg.head_dim)
        v = attn["v_proj"](h).reshape(b, l, cfg.num_kv_heads, cfg.head_dim)
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v

    def finish(self, x: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
        """The residual adds after attention ((B, L, H * Dh)): the output
        projection, then the gated MLP."""
        x = x + self.self_attn["o_proj"](attn)
        h = self.post_attention_layernorm(x)
        mlp = self.mlp
        gated = gelu_tanh(mlp["gate_proj"](h)) * mlp["up_proj"](h)
        return x + mlp["down_proj"](gated)


def grouped_causal_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor) -> torch.Tensor:
    """Causal attention of (B, L, H, Dh) q over (B, L, KV, Dh) k and v, KV
    dividing H (query head j reads KV head j // (H / KV), as ``jnp.repeat``
    lays them out): k and v expanded over the group, a view with head stride
    0 when KV is 1. Returns (B, L, H * Dh)."""
    b, l, h, dh = q.shape
    kv = k.shape[2]
    if kv != h:
        k, v = (x[:, :, :, None].expand(b, l, kv, h // kv, dh)
                .reshape(b, l, h, dh) for x in (k, v))
    return ops.attention(q, k, v, causal=True, layout="blhd").reshape(
        b, l, h * dh)


def grouped_decode_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor) -> torch.Tensor:
    """One decode position: (B, 1, H, Dh) q over the (B, T, KV, Dh) cache
    prefix k and v, unmasked. Each KV group's H / KV query heads become its
    query rows, a (B, H / KV, KV, Dh) view, so the flash kernel sees KV heads
    of H / KV rows each. Returns (B, 1, H * Dh)."""
    b, _, h, dh = q.shape
    kv = k.shape[2]
    rows = q.reshape(b, kv, h // kv, dh).transpose(1, 2)
    out = ops.attention(rows, k, v, layout="blhd")
    return out.transpose(1, 2).reshape(b, 1, h * dh)


class Gemma(nn.Module):
    """ids (B, L) -> next-token logits (B, L, V) (``gemma_apply``).

    A Gemma is built with zero float32 weights on ``device``: its weights
    come from a checkpoint (``load_hf_state_dict``,
    ``load_gemma_from_hf``, or ``load_state_dict`` with this module's
    names). The rotary tables for positions below ``cfg.max_len`` are
    buffers (not in the state dict)."""

    def __init__(self, cfg: GemmaConfig, *, device=None):
        super().__init__()
        if cfg.num_heads % cfg.num_kv_heads:
            raise ValueError(f"{cfg.num_kv_heads} KV heads do not divide "
                             f"{cfg.num_heads} query heads")
        self.cfg = cfg
        # Built on the meta device (no init draws), then allocated zeroed.
        factory = dict(device="meta", dtype=torch.float32)
        self.model = nn.Module()
        self.model.embed_tokens = nn.Embedding(cfg.vocab_size,
                                               cfg.hidden_size, **factory)
        self.model.layers = nn.ModuleList(
            GemmaLayer(cfg, factory) for _ in range(cfg.num_layers))
        self.model.norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, **factory)
        device = torch.device("cpu" if device is None else device)
        self.to_empty(device=device)
        with torch.no_grad():
            for p in self.parameters():
                p.zero_()
        cos, sin = rope_tables(torch.arange(cfg.max_len, device=device),
                               cfg.head_dim, cfg.rope_theta)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    def load_hf_state_dict(self, sd: dict) -> None:
        """Load an HF ``GemmaForCausalLM`` state dict. Gemma ties its head
        to the embedding: ``lm_head.weight``, when present, must equal
        ``model.embed_tokens.weight`` and is dropped."""
        sd = dict(sd)
        head = sd.pop("lm_head.weight", None)
        if head is not None and not torch.equal(
                head, sd["model.embed_tokens.weight"]):
            raise ValueError("lm_head.weight differs from the embedding; "
                             "Gemma ties its head")
        self.load_state_dict(sd, strict=True)

    def _embed(self, ids: torch.Tensor) -> torch.Tensor:
        return self.model.embed_tokens(ids) * math.sqrt(self.cfg.hidden_size)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(self.model.norm(x), self.model.embed_tokens.weight)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        """Full causal forward (``gemma_apply``)."""
        x = self._embed(ids)
        cos, sin = rope_tables(torch.arange(ids.shape[1], device=ids.device),
                               self.cfg.head_dim, self.cfg.rope_theta)
        for layer in self.model.layers:
            x = layer.finish(x, grouped_causal_attention(
                *layer.qkv(x, cos, sin)))
        return self._logits(x)

    def init_cache(self, batch: int) -> dict:
        """KV cache: (layers, B, max_len, KV, Dh) k and v in BLHD
        (time-major) layout, zero-filled, in the parameters' dtype and on
        their device, plus the position as a Python int, so a decode loop
        never reads the device."""
        cfg = self.cfg
        w = self.model.embed_tokens.weight
        shape = (cfg.num_layers, batch, cfg.max_len, cfg.num_kv_heads,
                 cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=w.dtype, device=w.device),
                "v": torch.zeros(shape, dtype=w.dtype, device=w.device),
                "pos": 0}

    def decode_step(self, cache: dict, token: torch.Tensor,
                    attn_len: int | None = None):
        """One KV-cached decode step (``gemma_decode_step``): token (B,) ->
        (logits (B, V), cache), with ``models.ar_lm.TinyGPT.decode_step``'s
        contract: k and v are written in place at slot ``pos``, attention
        reads the filled prefix ``[:pos + 1]`` as a strided view (the JAX
        step's masked slots get probability exactly 0), the returned dict
        carries ``pos + 1``, and ``attn_len`` only bounds ``pos``."""
        pos = cache["pos"]
        limit = self.cfg.max_len if attn_len is None else attn_len
        if pos >= limit:
            raise ValueError(f"decode position {pos} is past the attention "
                             f"window {limit}")
        k_all, v_all = cache["k"], cache["v"]
        cos = self.rope_cos[pos:pos + 1]
        sin = self.rope_sin[pos:pos + 1]
        x = self._embed(token)[:, None, :]
        for i, layer in enumerate(self.model.layers):
            q, k, v = layer.qkv(x, cos, sin)
            k_all[i, :, pos] = k[:, 0]
            v_all[i, :, pos] = v[:, 0]
            x = layer.finish(x, grouped_decode_attention(
                q, k_all[i, :, :pos + 1], v_all[i, :, :pos + 1]))
        logits = self._logits(x)[:, 0, :]
        return logits, {"k": k_all, "v": v_all, "pos": pos + 1}


def gemma_from_hf(hf_model, *, max_len: int = 512, device=None) -> Gemma:
    """A loaded HF causal LM -> the port's ``Gemma`` with its weights, on
    ``device``. Raises ValueError unless ``model_type`` is ``"gemma"``."""
    model_type = hf_model.config.model_type
    if model_type != "gemma":
        raise ValueError(f"not a Gemma-v1 checkpoint: {model_type}")
    model = Gemma(GemmaConfig.from_hf(hf_model.config, max_len=max_len),
                  device=device)
    model.load_hf_state_dict(hf_model.state_dict())
    return model.eval()


def load_gemma_from_hf(model_id: str, *, max_len: int = 512,
                       local_files_only: bool = True, device=None) -> Gemma:
    """Load an HF Gemma checkpoint into the port's ``Gemma`` on ``device``
    (``load_gemma_from_hf``). Raises if the model is not available locally
    (or at all), and ValueError when it is not a Gemma."""
    from transformers import AutoConfig, AutoModelForCausalLM

    hf_cfg = AutoConfig.from_pretrained(model_id,
                                        local_files_only=local_files_only)
    if hf_cfg.model_type != "gemma":
        raise ValueError(f"not a Gemma-v1 checkpoint: {hf_cfg.model_type}")
    hf_model = AutoModelForCausalLM.from_pretrained(
        model_id, local_files_only=local_files_only)
    return gemma_from_hf(hf_model, max_len=max_len, device=device)
