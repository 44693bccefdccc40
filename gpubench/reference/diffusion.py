"""The DDPM schedule, forward noising and the ancestral step, plainly
(Ho et al. 2020; the reference's ``linear_beta_schedule``, ``q_sample``
and ``p_sample``)."""

from __future__ import annotations

import numpy as np
import torch

from gpubench.reference import keytree


class Schedule:
    """The linear beta schedule's tables: float64 closed forms cast to
    float32 once, on ``device``."""

    def __init__(self, timesteps: int, device, start: float = 1e-4,
                 end: float = 2e-2):
        betas = np.linspace(start, end, timesteps, dtype=np.float64)
        alphas = 1.0 - betas
        acp = np.cumprod(alphas)

        def f32(a):
            return torch.from_numpy(a.astype(np.float32)).to(device)

        self.timesteps = timesteps
        self.betas = f32(betas)
        self.sqrt_acp = f32(np.sqrt(acp))
        self.sqrt_om = f32(np.sqrt(1.0 - acp))
        self.sqrt_recip = f32(1.0 / np.sqrt(alphas))
        self.sqrt_betas = f32(np.sqrt(betas))


def _at(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    return table[t].reshape(t.shape[0], *((1,) * (ndim - 1)))


def q_sample(s: Schedule, x0, t, noise):
    return _at(s.sqrt_acp, t, x0.ndim) * x0 + _at(s.sqrt_om, t,
                                                  x0.ndim) * noise


def p_sample(s: Schedule, x, t, eps, noise):
    """mu = (x - beta_t / sqrt(1 - acp_t) eps) / sqrt(alpha_t), plus
    sqrt(beta_t) noise where t > 0."""
    mean = _at(s.sqrt_recip, t, x.ndim) * (
        x - _at(s.betas, t, x.ndim) / _at(s.sqrt_om, t, x.ndim) * eps)
    nonzero = (t > 0).to(x.dtype).reshape(t.shape[0], *((1,) * (x.ndim - 1)))
    return mean + nonzero * _at(s.sqrt_betas, t, x.ndim) * noise


def ancestral_rows(denoise, s: Schedule, shape, key, rows, device):
    """Rows ``rows`` of one whole ancestral batch of ``shape`` drawn from
    ``key``, as the program's sampler draws it: (init, loop) = split(key),
    x_T = normal(init), step t's noise normal(fold_in(loop, t)); the other
    rows are never computed (a denoiser treats each row apart)."""
    init_key, loop_key = keytree.split(key)
    idx = keytree.rows_index(shape, rows, device)
    x = keytree.normal(init_key, idx)
    for t in range(s.timesteps - 1, -1, -1):
        t_b = torch.full((len(rows),), t, dtype=torch.int64, device=device)
        eps = denoise(x, t_b)
        x = p_sample(s, x, t_b, eps,
                     keytree.normal(keytree.fold_in(loop_key, t), idx))
    return x
