"""TinyDiffusionModels on PyTorch and CUDA: the port of ``tinydiffusionmodels_tpu``.

The JAX package beside this one is the reference that every module here is
held against. This package imports ``torch`` and never ``jax``: modules of the
JAX package that are themselves jax-free (``.env`` loading, checkpoint storage
and its ``.pth`` codec, the corpus loader and tokenizers, the CLI's argument
parser) are reused by import instead of being copied.

The first slice is text sampling from a trained checkpoint::

    python -m tinydiffusionmodels_torch.shakespeare --sample --ckpt X.pth

Attention on a CUDA tensor runs through a hand-written CUDA flash-attention
forward (``ops/flash_attention.py``, ``csrc/flash_attention_fwd.cu``); on a
CPU tensor through its plain PyTorch version (``ops/reference.py``).
"""

# Importing the package loads .env exactly as the JAX package does (that
# module imports nothing of jax).
import tinydiffusionmodels_tpu._env  # noqa: F401

__version__ = "0.1.0"
