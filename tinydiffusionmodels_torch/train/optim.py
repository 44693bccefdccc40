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
    """AdamW with torch defaults (betas=(0.9, 0.999), eps=1e-8).

    For parameters on the card it is built for CUDA graphs:
    ``capturable=True`` (its step count and bias corrections stay on the
    card) and the learning rate a float32 tensor there, which a captured
    step rewrites in place (``train/chunks.py``); and ``fused=True``, one
    kernel for every parameter where the capturable multi-tensor update
    launches about a hundred (a replayed text step at bs 8 took 1463
    against 1776 µs on an H100 80GB HBM3 at 700 W, PERF.md §6). Torch
    refuses ``capturable`` for CPU parameters, so on the CPU the learning
    rate stays a float."""
    params = list(params)
    if params and params[0].is_cuda:
        return torch.optim.AdamW(
            params, lr=torch.tensor(float(lr), device=params[0].device),
            betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay,
            capturable=True, fused=True,
        )
    return torch.optim.AdamW(
        params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay
    )


def load_adamw_state(optimizer: torch.optim.AdamW, params: nn.Module,
                     step: int, exp_avg: dict, exp_avg_sq: dict) -> None:
    """Set AdamW's state of every parameter of ``params`` it steps: its
    step count and moments (``exp_avg``, ``exp_avg_sq``: parameter name ->
    tensor), for resuming a run.

    AdamW creates its state lazily, in its first step; this creates it as
    that step would (``step`` a float32 scalar on the parameter's device
    when capturable or fused, on the CPU otherwise; the moments shaped as
    the parameter) and copies the values into it, so that a step warmed up
    or captured afterwards (``graphs.Step``) finds it and keeps its
    addresses. Parameters the optimizer does not step are skipped."""
    group_of = {p: g for g in optimizer.param_groups for p in g["params"]}
    with torch.no_grad():
        for name, p in params.named_parameters():
            group = group_of.get(p)
            if group is None:
                continue
            state = optimizer.state[p]
            if not state:
                on_device = group["capturable"] or group["fused"]
                state["step"] = torch.zeros(
                    (), dtype=torch.float32,
                    device=p.device if on_device else "cpu")
                state["exp_avg"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                state["exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
            state["step"].fill_(float(step))
            state["exp_avg"].copy_(exp_avg[name])
            state["exp_avg_sq"].copy_(exp_avg_sq[name])


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
