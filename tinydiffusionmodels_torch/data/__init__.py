"""Corpus, tokenizers and batching of the port.

The port's own copies of the JAX package's jax-free data modules
(``tinydiffusionmodels_tpu/data/{shakespeare,tokenizer,loader,mnist}.py``),
with the same names, so that both packages read the same corpus and digits,
tokenize them the same way and batch them in the same order, while the port
imports nothing of the JAX package.
"""

from tinydiffusionmodels_torch.data.loader import (
    batch_iterator,
    num_batches,
    tokenize_corpus,
)
from tinydiffusionmodels_torch.data.mnist import load_mnist, normalize_mnist
from tinydiffusionmodels_torch.data.shakespeare import load_text_corpus
from tinydiffusionmodels_torch.data.tokenizer import (
    BPETokenizer,
    CharTokenizer,
    HFTokenizerAdapter,
    parse_bpe_spec,
    tokenizer_from_state,
)

__all__ = [
    "BPETokenizer",
    "CharTokenizer",
    "HFTokenizerAdapter",
    "batch_iterator",
    "load_mnist",
    "load_text_corpus",
    "normalize_mnist",
    "num_batches",
    "parse_bpe_spec",
    "tokenize_corpus",
    "tokenizer_from_state",
]
