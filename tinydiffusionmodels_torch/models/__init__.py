"""Models of the port: the text denoiser, the embedding/rounding heads, the
guided sampler's base LMs (TinyGPT, and Gemma for a Hugging Face Gemma
checkpoint), the MNIST UNet and the digit classifier that measures its
samples."""

from tinydiffusionmodels_torch.models.ar_lm import TinyGPT, TinyGPTConfig
from tinydiffusionmodels_torch.models.classifier import DigitClassifier
from tinydiffusionmodels_torch.models.embedding import (
    LearnedEmbedding,
    LearnedRounding,
    cosine_logits,
    embedding_matrix,
    rounding_apply,
)
from tinydiffusionmodels_torch.models.gemma import Gemma, GemmaConfig
from tinydiffusionmodels_torch.models.transformer import (
    TinyTransformer,
    TransformerConfig,
)
from tinydiffusionmodels_torch.models.unet import SimpleUNet

__all__ = [
    "DigitClassifier",
    "Gemma",
    "GemmaConfig",
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
