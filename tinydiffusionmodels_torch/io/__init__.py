"""Checkpoint I/O of the port.

``storage`` is the port's own copy of the JAX package's storage (local or
GCS ``.pth`` load/save, sample files), writing the same format with
``torch.save``; ``convert`` maps its numpy state dicts to and from the port's
modules; ``images`` is the port's copy of the PNG grid writer.
"""

from tinydiffusionmodels_torch.io.convert import (
    adamw_state_from_jax,
    adamw_state_to_jax,
    classifier_state_from_jax,
    config_from_state_dict,
    embedding_state_from_jax,
    gemma_state_from_jax,
    rounding_state_from_jax,
    state_from_checkpoint,
    text_checkpoint_dict,
    tiny_gpt_params_dict,
    tiny_gpt_state_from_jax,
    transformer_state_from_jax,
    unet_checkpoint_dict,
    unet_params_dict,
    unet_state_from_jax,
)
from tinydiffusionmodels_torch.io.images import grid_png
from tinydiffusionmodels_torch.io.storage import (
    get_samples_dir,
    get_vertex_checkpoint_path,
    load_checkpoint,
    save_checkpoint,
    save_samples,
)

__all__ = [
    "adamw_state_from_jax",
    "adamw_state_to_jax",
    "classifier_state_from_jax",
    "config_from_state_dict",
    "embedding_state_from_jax",
    "gemma_state_from_jax",
    "get_samples_dir",
    "grid_png",
    "get_vertex_checkpoint_path",
    "load_checkpoint",
    "rounding_state_from_jax",
    "save_checkpoint",
    "save_samples",
    "state_from_checkpoint",
    "text_checkpoint_dict",
    "tiny_gpt_params_dict",
    "tiny_gpt_state_from_jax",
    "transformer_state_from_jax",
    "unet_checkpoint_dict",
    "unet_params_dict",
    "unet_state_from_jax",
]
