"""Optimizer and schedules (port of ``train/optim.py``), matching the
reference's choices.

- AdamW with torch-default betas/eps (reference src/shakespeare.py:197).
  ``torch.optim.AdamW`` equals the JAX package's optax ``adamw``: both apply
  decoupled weight decay scaled by the learning rate, and bias-corrected
  Adam moments.
- Cosine anneal with linear warmup, the reference's LambdaLR formula
  (src/shakespeare.py:159-167), as a lambda for
  ``torch.optim.lr_scheduler.LambdaLR``.
- Dynamic rounding-loss weight decay (src/shakespeare.py:169-172).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch
from torch import nn


def cosine_warmup_lambda(
    num_warmup_steps: int,
    num_training_steps: int,
    eta_min: float = 0.0,
) -> Callable[[int], float]:
    """lr(step) / base_lr of the JAX package's ``cosine_schedule_with_warmup``
    (reference src/shakespeare.py:161-165): linear warmup, then cosine."""

    def lr_lambda(step: int) -> float:
        if step < num_warmup_steps:
            return step / max(1.0, float(num_warmup_steps))
        progress = (step - num_warmup_steps) / max(
            1.0, float(num_training_steps - num_warmup_steps)
        )
        return max(float(eta_min), 0.5 * (1.0 + math.cos(math.pi * progress)))

    return lr_lambda


def adamw(
    params: Iterable[nn.Parameter],
    lr: float,
    weight_decay: float = 1e-4,
) -> torch.optim.AdamW:
    """AdamW with torch defaults (betas=(0.9, 0.999), eps=1e-8)."""
    return torch.optim.AdamW(
        params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay
    )


def freeze_subtree(joint: nn.ModuleDict, name: str) -> list[nn.Parameter]:
    """The parameters of ``joint`` outside its module ``name``.

    Used for --freeze_embeddings: stop-gradient alone would leave AdamW's
    decoupled weight decay shrinking the table by lr*wd each step, so the
    frozen module's parameters are kept out of the optimizer: no update and
    no decay (the JAX package zeroes their optax updates instead).
    """
    return [
        p for key, module in joint.items() if key != name
        for p in module.parameters()
    ]


def dynamic_rounding_weight_schedule(
    epoch: int,
    total_epochs: int,
    initial_weight: float = 1.0,
    final_weight: float = 0.1,
) -> float:
    """Linear decay of the rounding-loss weight across epochs
    (reference src/shakespeare.py:169-172)."""
    progress = epoch / total_epochs
    return initial_weight * (1 - progress) + final_weight * progress
