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


def _default_generator(generator: torch.Generator | None) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


def init_linear_(
    layer: nn.Linear, generator: torch.Generator | None = None
) -> None:
    """torch's nn.Linear default init, U(+-1/sqrt(fan_in)) for weight and
    bias, drawn from ``generator``."""
    g = _default_generator(generator)
    bound = 1.0 / math.sqrt(layer.in_features)
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=g)
        if layer.bias is not None:
            layer.bias.uniform_(-bound, bound, generator=g)


class LearnedEmbedding(nn.Module):
    """Trainable (vocab, dim) table, N(0, 0.02) init.

    ``pretrained`` (vocab, pre_dim) initializes the table instead; when
    pre_dim != dim it is projected through a random, untrained
    Linear(pre_dim, dim, bias=False), the reference's quirk."""

    def __init__(
        self,
        vocab_size: int,
        embed_dim: int,
        *,
        pretrained: np.ndarray | torch.Tensor | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        # _weight skips nn.Embedding's own draw from the global RNG.
        self.embeddings = nn.Embedding(
            vocab_size, embed_dim, _weight=torch.empty(vocab_size, embed_dim)
        )
        g = _default_generator(generator)
        with torch.no_grad():
            if pretrained is None:
                self.embeddings.weight.normal_(0.0, 0.02, generator=g)
                return
            pre = torch.as_tensor(np.asarray(pretrained), dtype=torch.float32)
            if pre.shape[0] != vocab_size:
                raise ValueError(
                    f"pretrained vocab {pre.shape[0]} != {vocab_size}"
                )
            if pre.shape[1] != embed_dim:
                bound = 1.0 / math.sqrt(pre.shape[1])
                proj = torch.empty(pre.shape[1], embed_dim).uniform_(
                    -bound, bound, generator=g
                )
                pre = pre @ proj
            self.embeddings.weight.copy_(pre)


class LearnedRounding(nn.Module):
    """One Linear(dim, vocab) decoding embeddings to token logits."""

    def __init__(
        self,
        embed_dim: int,
        vocab_size: int,
        *,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.decoder = nn.utils.skip_init(nn.Linear, embed_dim, vocab_size)
        init_linear_(self.decoder, generator)

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
