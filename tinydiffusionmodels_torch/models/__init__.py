"""Models of the port: the text denoiser, the embedding/rounding heads and
the guided sampler's base LM (TinyGPT)."""

from tinydiffusionmodels_torch.models.ar_lm import TinyGPT, TinyGPTConfig
from tinydiffusionmodels_torch.models.embedding import (
    LearnedEmbedding,
    LearnedRounding,
    cosine_logits,
    embedding_matrix,
    rounding_apply,
)
from tinydiffusionmodels_torch.models.transformer import (
    TinyTransformer,
    TransformerConfig,
)

__all__ = [
    "LearnedEmbedding",
    "LearnedRounding",
    "TinyGPT",
    "TinyGPTConfig",
    "TinyTransformer",
    "TransformerConfig",
    "cosine_logits",
    "embedding_matrix",
    "rounding_apply",
]
