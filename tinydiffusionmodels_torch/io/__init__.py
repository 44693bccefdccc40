"""Checkpoint I/O of the port.

Storage (local or GCS ``.pth`` load/save, sample files) is the JAX package's
own jax-free ``tinydiffusionmodels_tpu.io``, reused by import and re-exported
here; ``convert`` maps its numpy state dicts to and from the port's modules.
"""

from tinydiffusionmodels_tpu.io.storage import (
    get_samples_dir,
    load_checkpoint,
    save_checkpoint,
    save_samples,
)
from tinydiffusionmodels_torch.io.convert import (
    config_from_state_dict,
    embedding_state_from_jax,
    rounding_state_from_jax,
    state_from_checkpoint,
    text_checkpoint_dict,
    transformer_state_from_jax,
)

__all__ = [
    "config_from_state_dict",
    "embedding_state_from_jax",
    "get_samples_dir",
    "load_checkpoint",
    "rounding_state_from_jax",
    "save_checkpoint",
    "save_samples",
    "state_from_checkpoint",
    "text_checkpoint_dict",
    "transformer_state_from_jax",
]
