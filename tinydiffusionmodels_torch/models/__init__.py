"""Models of the port: the text denoiser and the embedding/rounding heads."""

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
    "TinyTransformer",
    "TransformerConfig",
    "cosine_logits",
    "embedding_matrix",
    "rounding_apply",
]
