"""Corpus and tokenizers of the port.

These are the JAX package's own loaders (``tinydiffusionmodels_tpu.data``),
which import nothing of jax, reused by import so that both packages read the
same corpus and tokenize it the same way.
"""

from tinydiffusionmodels_tpu.data.shakespeare import load_text_corpus
from tinydiffusionmodels_tpu.data.tokenizer import (
    BPETokenizer,
    CharTokenizer,
    parse_bpe_spec,
    tokenizer_from_state,
)

__all__ = [
    "BPETokenizer",
    "CharTokenizer",
    "load_text_corpus",
    "parse_bpe_spec",
    "tokenizer_from_state",
]
