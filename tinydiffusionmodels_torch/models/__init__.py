"""Models of the port: the text denoiser, the embedding/rounding heads, the
guided sampler's base LM (TinyGPT) and the MNIST UNet."""

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
from tinydiffusionmodels_torch.models.unet import SimpleUNet

__all__ = [
    "LearnedEmbedding",
    "LearnedRounding",
    "SimpleUNet",
    "TinyGPT",
    "TinyGPTConfig",
    "TinyTransformer",
    "TransformerConfig",
    "cosine_logits",
    "embedding_matrix",
    "rounding_apply",
]
