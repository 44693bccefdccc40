"""TinyDiffusionModels on PyTorch and CUDA: the port of ``tinydiffusionmodels_tpu``.

The JAX package beside this one is the reference that every module here is
held against. This package imports ``torch`` and never ``jax``, and nothing
of the JAX package either: the jax-free pieces it needs (``.env`` loading,
the corpus loader and tokenizers, checkpoint storage, the CLI's argument
parser) are its own copies, under the JAX package's names.

Text sampling from a trained checkpoint, text-diffusion training and guided
AR + diffusion decoding with the TinyGPT base LM::

    python -m tinydiffusionmodels_torch.shakespeare --sample --ckpt X.pth
    python -m tinydiffusionmodels_torch.shakespeare --train --ckpt X.pth
    python -m tinydiffusionmodels_torch.shakespeare --guided_sample \
        --base_lm tinygpt --ckpt X.pth

On CUDA tensors attention runs through hand-written CUDA flash-attention
kernels, forward with dropout and the recompute backward
(``ops/flash_attention.py``), and the exact guided decode drafts with a
persistent guided-decode kernel (``ops/decode_kernel.py``), all built from
``csrc/``; on CPU tensors each runs its plain PyTorch version
(``ops/reference.py``).
"""

from tinydiffusionmodels_torch._env import load_dotenv as _load_dotenv

_load_dotenv()

__version__ = "0.1.0"
