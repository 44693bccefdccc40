"""Forward noising, the reverse (ancestral and DDIM) steps and the DDPM
loss (port of ``core/diffusion.py``).

Rank-generic as in the JAX package: timesteps are a (B,) integer tensor and
may differ per batch element. Noise is always an explicit tensor argument, so
a caller decides where it comes from (the JAX package's keys, drawn by
``ops.rng``, or draws a test feeds both packages).
"""

from __future__ import annotations

import torch

from tinydiffusionmodels_torch.core.schedule import DiffusionSchedule


def _bcast(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather (T,) coefficients at (B,) timesteps, shaped (B, 1, ..., 1)."""
    coef = table[t]
    return coef.reshape(coef.shape[0], *((1,) * (ndim - 1)))


def q_sample(
    sched: DiffusionSchedule,
    x_start: torch.Tensor,
    t: torch.Tensor,
    noise: torch.Tensor,
) -> torch.Tensor:
    """q(x_t | x_0): sqrt(acp_t) * x_0 + sqrt(1 - acp_t) * noise."""
    sqrt_acp = _bcast(sched.sqrt_alphas_cumprod, t, x_start.ndim)
    sqrt_om = _bcast(sched.sqrt_one_minus_alphas_cumprod, t, x_start.ndim)
    return sqrt_acp * x_start + sqrt_om * noise


def eps_from_x0(
    sched: DiffusionSchedule,
    x_t: torch.Tensor,
    t: torch.Tensor,
    x0_pred: torch.Tensor,
) -> torch.Tensor:
    """The eps-prediction equivalent to an x0-prediction (inverts q_sample)."""
    sqrt_acp = _bcast(sched.sqrt_alphas_cumprod, t, x_t.ndim)
    sqrt_om = _bcast(sched.sqrt_one_minus_alphas_cumprod, t, x_t.ndim)
    return (x_t - sqrt_acp * x0_pred) / sqrt_om


def p_sample_mean(
    sched: DiffusionSchedule,
    x: torch.Tensor,
    t: torch.Tensor,
    eps_pred: torch.Tensor,
) -> torch.Tensor:
    """mu = 1/sqrt(alpha_t) * (x - beta_t / sqrt(1 - acp_t) * eps_hat)."""
    betas_t = _bcast(sched.betas, t, x.ndim)
    sqrt_om = _bcast(sched.sqrt_one_minus_alphas_cumprod, t, x.ndim)
    sqrt_recip = _bcast(sched.sqrt_recip_alphas, t, x.ndim)
    return sqrt_recip * (x - betas_t / sqrt_om * eps_pred)


def p_sample(
    sched: DiffusionSchedule,
    x: torch.Tensor,
    t: torch.Tensor,
    eps_pred: torch.Tensor,
    noise: torch.Tensor,
    *,
    noise_scale: float = 1.0,
) -> torch.Tensor:
    """One ancestral step with posterior variance beta_t; adds
    ``noise_scale * sqrt(beta_t) * noise`` except where t == 0."""
    mean = p_sample_mean(sched, x, t, eps_pred)
    sqrt_beta = _bcast(sched.sqrt_betas, t, x.ndim)
    nonzero = (t > 0).to(x.dtype).reshape(t.shape[0], *((1,) * (x.ndim - 1)))
    return mean + noise_scale * nonzero * sqrt_beta * noise


def ddim_step(
    sched: DiffusionSchedule,
    x: torch.Tensor,
    t: torch.Tensor,
    t_prev: torch.Tensor,
    eps_pred: torch.Tensor,
    *,
    eta: float = 0.0,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """One DDIM step (Song et al. 2020); ``t_prev`` < 0 returns x0_hat.

    With ``eta`` > 0 the step is stochastic and ``noise`` is required."""
    acp_t = _bcast(sched.alphas_cumprod, t, x.ndim)
    t_prev_c = torch.clamp(t_prev, 0, sched.timesteps - 1)
    acp_prev = _bcast(sched.alphas_cumprod, t_prev_c, x.ndim)
    is_final = (t_prev < 0).to(x.dtype).reshape(
        t_prev.shape[0], *((1,) * (x.ndim - 1))
    )
    acp_prev = acp_prev * (1.0 - is_final) + is_final  # acp_{-1} := 1

    x0_hat = (x - torch.sqrt(1.0 - acp_t) * eps_pred) / torch.sqrt(acp_t)
    sigma = eta * torch.sqrt(
        (1.0 - acp_prev) / (1.0 - acp_t) * (1.0 - acp_t / acp_prev)
    )
    dir_xt = torch.sqrt(torch.clamp(1.0 - acp_prev - sigma**2, min=0.0)) * eps_pred
    x_prev = torch.sqrt(acp_prev) * x0_hat + dir_xt
    if eta > 0.0:
        if noise is None:
            raise ValueError("eta > 0 requires noise")
        x_prev = x_prev + (1.0 - is_final) * sigma * noise
    return x_prev


def ddpm_loss(
    sched: DiffusionSchedule,
    denoise_fn,
    x_start: torch.Tensor,
    t: torch.Tensor,
    noise: torch.Tensor,
    *,
    compute_dtype=None,
) -> torch.Tensor:
    """Epsilon-prediction MSE (reference src/mnist.py:154-158):
    mean((denoise_fn(q_sample(x_start, t, noise), t) - noise)^2).

    ``compute_dtype`` (bf16) casts ``x_noisy`` before ``denoise_fn``, whose
    caller casts its parameters (``train/precision.py``); the MSE is taken
    in f32 against the f32 noise."""
    x_noisy = q_sample(sched, x_start, t, noise)
    if compute_dtype is not None:
        x_noisy = x_noisy.to(compute_dtype)
    eps_pred = denoise_fn(x_noisy, t)
    return torch.mean((eps_pred.float() - noise) ** 2)
