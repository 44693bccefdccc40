"""LearnedEmbedding and LearnedRounding (port of ``models/embedding.py``).

Parameter names follow the reference's torch modules, so the state dicts the
JAX package writes (``embeddings.weight``; ``decoder.weight`` and
``decoder.bias``) load with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from tinydiffusionmodels_torch.io import convert
from tinydiffusionmodels_torch.models import init


class LearnedEmbedding(nn.Module):
    """Trainable (vocab, dim) table: ``init_learned_embedding``'s from
    ``key``, drawn on ``device``: 0.02 N(0, 1), or ``pretrained`` (vocab,
    pre_dim), projected through a random, untrained Linear(pre_dim, dim,
    bias=False) when pre_dim != dim (the reference's quirk)."""

    def __init__(
        self,
        vocab_size: int,
        embed_dim: int,
        *,
        pretrained: np.ndarray | torch.Tensor | None = None,
        key=None,
        device=None,
    ):
        super().__init__()
        # _weight skips nn.Embedding's own draw from the global RNG.
        self.embeddings = nn.Embedding(
            vocab_size, embed_dim, _weight=torch.empty(vocab_size, embed_dim)
        )
        self.to(device)
        # nn.utils.skip_init builds a module to load into: no draw.
        if self.embeddings.weight.is_meta:
            return
        if torch.is_tensor(pretrained):
            pretrained = pretrained.detach().cpu()
        self.load_state_dict(convert.embedding_state_from_jax(
            init.init_learned_embedding(init.default_key(key), vocab_size,
                                        embed_dim, pretrained,
                                        self.embeddings.weight.device)))


class LearnedRounding(nn.Module):
    """One Linear(dim, vocab) decoding embeddings to token logits:
    ``init_learned_rounding``'s from ``key``, drawn on ``device``."""

    def __init__(self, embed_dim: int, vocab_size: int, *, key=None,
                 device=None):
        super().__init__()
        self.decoder = nn.utils.skip_init(nn.Linear, embed_dim, vocab_size)
        self.to(device)
        # nn.utils.skip_init builds a module to load into: no draw.
        if self.decoder.weight.is_meta:
            return
        self.load_state_dict(convert.rounding_state_from_jax(
            init.init_learned_rounding(init.default_key(key), embed_dim,
                                       vocab_size,
                                       self.decoder.weight.device)))

    def forward(self, embeddings: torch.Tensor) -> torch.Tensor:
        return self.decoder(embeddings)


def rms_normalize_rows(w: torch.Tensor) -> torch.Tensor:
    """Scale each row to L2 = sqrt(dim), i.e. per-coordinate RMS 1."""
    d = w.shape[-1]
    scale = math.sqrt(d) / (
        torch.linalg.vector_norm(w, dim=-1, keepdim=True) + 1e-12
    )
    return w * scale


def zscore_table(w: torch.Tensor) -> torch.Tensor:
    """Whiten the (vocab, dim) table per coordinate across the vocab axis."""
    mu = torch.mean(w, dim=0, keepdim=True)
    sd = torch.std(w, dim=0, keepdim=True, correction=0) + 1e-6
    return (w - mu) / sd


def _apply_norm(x: torch.Tensor, norm: str) -> torch.Tensor:
    """Normalize a (vocab, dim) table: 'none', 'rms' or 'zscore'."""
    if norm == "none":
        return x
    if norm == "rms":
        return rms_normalize_rows(x)
    if norm == "zscore":
        return zscore_table(x)
    raise ValueError(f"unknown embed_norm: {norm!r}")


def embedding_matrix(weight: torch.Tensor, *, norm: str = "none") -> torch.Tensor:
    """(vocab, dim) table for cosine and clamp decoding; ``norm`` must match
    how the checkpoint was trained (its 'embed_norm' key)."""
    return _apply_norm(weight, norm)


def rounding_apply(rounding: LearnedRounding, embeddings: torch.Tensor):
    """(..., dim) -> (..., vocab) token logits."""
    return rounding(embeddings)


def cosine_logits(embed_matrix: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Cosine similarity of (..., dim) x against every (V, dim) table row."""
    emb_n = embed_matrix / (
        torch.linalg.vector_norm(embed_matrix, dim=-1, keepdim=True) + 1e-12
    )
    x_n = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)
    return x_n @ emb_n.T
