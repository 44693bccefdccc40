"""Diffusion noise schedules (port of ``core/schedule.py``).

The tables are computed by the same float64 numpy closed forms as the JAX
package and cast to float32 once, so the two packages hold bit-identical
tables. (The JAX module imports jax, so its formulas are repeated here.)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

DEFAULT_TIMESTEPS = 1000
DEFAULT_BETA_START = 1e-4
DEFAULT_BETA_END = 2e-2


def linear_beta_schedule(
    timesteps: int,
    start: float = DEFAULT_BETA_START,
    end: float = DEFAULT_BETA_END,
) -> np.ndarray:
    """Linear beta schedule (Ho et al. 2020), float64."""
    return np.linspace(start, end, timesteps, dtype=np.float64)


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    """Cosine schedule (Nichol & Dhariwal 2021, eq. 17), float64."""
    steps = np.arange(timesteps + 1, dtype=np.float64)
    f = np.cos(((steps / timesteps) + s) / (1 + s) * np.pi / 2) ** 2
    alphas_cumprod = f / f[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0.0, 0.999)


def sqrt_beta_schedule(timesteps: int, s: float = 1e-4) -> np.ndarray:
    """Diffusion-LM's text schedule: alpha_bar(t) = 1 - sqrt(t/T + s)."""
    steps = np.arange(timesteps + 1, dtype=np.float64)
    alphas_cumprod = 1.0 - np.sqrt(steps / timesteps + s)
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0.0, 0.999)


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """All precomputed DDPM tables, shape (T,), float32, on one device."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas: torch.Tensor
    sqrt_betas: torch.Tensor
    timesteps: int


def make_schedule(
    timesteps: int = DEFAULT_TIMESTEPS,
    *,
    kind: str = "linear",
    start: float = DEFAULT_BETA_START,
    end: float = DEFAULT_BETA_END,
    device=None,
) -> DiffusionSchedule:
    """Build a DiffusionSchedule; float64 closed form, cast once at the end."""
    if kind == "linear":
        betas = linear_beta_schedule(timesteps, start, end)
    elif kind == "cosine":
        betas = cosine_beta_schedule(timesteps)
    elif kind == "sqrt":
        betas = sqrt_beta_schedule(timesteps)
    else:
        raise ValueError(f"Unknown schedule kind: {kind!r}")

    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas)
    tables = dict(
        betas=betas,
        alphas=alphas,
        alphas_cumprod=alphas_cumprod,
        sqrt_alphas_cumprod=np.sqrt(alphas_cumprod),
        sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - alphas_cumprod),
        sqrt_recip_alphas=1.0 / np.sqrt(alphas),
        sqrt_betas=np.sqrt(betas),
    )
    return DiffusionSchedule(
        timesteps=timesteps,
        **{
            k: torch.from_numpy(v.astype(np.float32)).to(device)
            for k, v in tables.items()
        },
    )
