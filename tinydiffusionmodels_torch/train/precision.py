"""Mixed-precision policy: bf16 compute, f32 master parameters and optimizer
state (port of ``train/precision.py``).

The trainers take ``compute_dtype=torch.bfloat16`` and cast the parameters
inside the loss: ``torch.func.functional_call(module, cast_floating(
dict(module.named_parameters()), dtype), ...)``. ``.to(dtype)`` is
differentiable, so the gradients arrive in f32 on the master parameters and
AdamW's state stays f32, as the cast's transpose gives the JAX package.
Losses are always reduced in f32. ``torch.autocast`` is not used: it keeps
LayerNorm, softmax and some matmuls in f32, so its rounding points are not
the JAX package's.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.func import functional_call


def cast_floating(params: dict, dtype) -> dict:
    """``params`` ({name: tensor}) with every floating tensor cast to
    ``dtype`` and everything else as it was; ``params`` itself for None."""
    if dtype is None:
        return params
    return {name: t.to(dtype) if torch.is_tensor(t) and t.is_floating_point()
            else t for name, t in params.items()}


def in_dtype(module: nn.Module, dtype):
    """``module`` as a function run on its floating parameters cast to
    ``dtype`` now, differentiably, so the gradients of a loss built inside
    the same step reach the f32 parameters; ``module`` itself for None.
    Make one per step: the cast copies do not follow later updates."""
    if dtype is None:
        return module
    params = cast_floating(dict(module.named_parameters()), dtype)
    return lambda *args, **kwargs: functional_call(module, params, args,
                                                   kwargs)


def resolve_compute_dtype(name: str | None):
    """Map a CLI/env string ('bf16', 'f32', None) to a dtype or None."""
    if name in (None, "", "f32", "float32"):
        return None
    if name in ("bf16", "bfloat16"):
        return torch.bfloat16
    raise ValueError(f"unknown compute dtype: {name!r}")
