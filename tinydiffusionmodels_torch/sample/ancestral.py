"""The reverse-diffusion sampling loop (port of ``sample/ancestral.py``).

The JAX package's ``lax.scan`` becomes a Python loop over timestep tensors
built before the loop. Nothing inside the loop reads a device value on the
host (no ``.item()``, no Python branch on a tensor), so on the card the
steps are enqueued back to back and x never leaves device memory.

Randomness comes in as arguments: a ``torch.Generator``, or an explicit
``x_T`` and a per-step ``noise_fn(t)`` (t is the timestep as a Python int,
the index the JAX sampler folds into its key), which lets the parity tests
replay the JAX package's draws.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from tinydiffusionmodels_torch.core.diffusion import ddim_step, p_sample
from tinydiffusionmodels_torch.core.schedule import DiffusionSchedule

DenoiseFn = Callable[..., torch.Tensor]
NoiseFn = Callable[[int], torch.Tensor]


def sample_loop(
    denoise_fn: DenoiseFn,
    sched: DiffusionSchedule,
    shape: tuple[int, ...],
    *,
    method: str = "ancestral",
    num_steps: int | None = None,
    eta: float = 0.0,
    self_cond: bool = False,
    temperature: float = 1.0,
    generator: torch.Generator | None = None,
    x_T: torch.Tensor | None = None,
    noise_fn: NoiseFn | None = None,
) -> torch.Tensor:
    """Run the full reverse process from N(0, I) noise on ``sched``'s device.

    denoise_fn: (x_t, t) -> eps_hat; with ``self_cond`` it is (x_t, t,
    x0_prev) -> (eps_hat, x0_est), and x0_est is carried to the next step
    (zeros at the first).
    method 'ancestral': DDPM, sched.timesteps steps (reference parity).
    method 'ddim': ``num_steps`` strided DDIM steps (default 50).
    method 'dpm++': DPM-Solver++(2M), ``num_steps`` steps (default 20).
    ``temperature`` scales the ancestral path's injected noise; with the
    deterministic solvers anything but 1 is rejected, not ignored.
    """
    if temperature != 1.0 and method != "ancestral":
        raise ValueError(
            f"temperature={temperature} has no effect with method="
            f"'{method}': dpm++ is deterministic and ddim's noise knob is "
            "eta. Use method='ancestral' (or eta for ddim)."
        )
    if method not in ("ancestral", "ddim", "dpm++"):
        raise ValueError(f"unknown sampling method: {method!r}")
    draws_noise = method == "ancestral" or (method == "ddim" and eta > 0.0)
    if generator is None and (x_T is None or (draws_noise and noise_fn is None)):
        raise ValueError(
            "pass a torch.Generator, or x_T (and noise_fn for a stochastic "
            "sampler): the sampler draws from no global RNG"
        )
    device = sched.betas.device

    def normal(_t: int | None = None) -> torch.Tensor:
        return torch.randn(shape, generator=generator, device=device)

    x = normal() if x_T is None else x_T.to(device=device, dtype=torch.float32)
    noise_fn = noise_fn or normal
    batch = shape[0]

    if self_cond:
        sc = torch.zeros(shape, device=device)

        def call(x, t_b, sc):
            return denoise_fn(x, t_b, sc)
    else:
        sc = None

        def call(x, t_b, sc):
            return denoise_fn(x, t_b), sc

    def steps_on_device(ts: np.ndarray) -> torch.Tensor:
        """(n,) host timesteps -> (n, batch) device rows, one per step."""
        rows = torch.as_tensor(np.ascontiguousarray(ts), dtype=torch.long)
        return rows.to(device)[:, None].expand(len(ts), batch)

    if method == "ancestral":
        ts = np.arange(sched.timesteps - 1, -1, -1)
        t_rows = steps_on_device(ts)
        for i, t in enumerate(ts.tolist()):
            t_b = t_rows[i]
            eps, sc = call(x, t_b, sc)
            x = p_sample(sched, x, t_b, eps, noise_fn(t),
                         noise_scale=temperature)
        return x

    if method == "dpm++":
        # DPM-Solver++(2M) (Lu et al. 2022): second-order multistep in
        # log-SNR space on the data prediction.
        n = num_steps or 20
        ts = np.linspace(0, sched.timesteps - 1, n + 1).round().astype(
            np.int64
        )[::-1]
        t_rows = steps_on_device(ts)
        acp = sched.alphas_cumprod[t_rows[:, 0]]
        alphas = torch.sqrt(acp)
        sigmas = torch.sqrt(torch.clamp(1.0 - acp, min=1e-12))
        lams = torch.log(alphas / sigmas)
        x0_prev = h_prev = None
        for i in range(n):
            eps, sc = call(x, t_rows[i], sc)
            a_cur, s_cur = alphas[i], sigmas[i]
            a_nxt, s_nxt = alphas[i + 1], sigmas[i + 1]
            x0 = (x - s_cur * eps) / a_cur
            h = lams[i + 1] - lams[i]
            if i == 0:  # first step: first-order update
                d = x0
            else:
                d = x0 + (0.5 / (h_prev / h)) * (x0 - x0_prev)
            x = (s_nxt / s_cur) * x - a_nxt * torch.expm1(-h) * d
            x0_prev, h_prev = x0, h
        return x

    n = num_steps or 50  # ddim
    # Strided ladder t_i = round(i * T / n), descending; the final t_prev of
    # -1 means "emit x0_hat".
    ts = np.linspace(0, sched.timesteps - 1, n).round().astype(np.int64)[::-1]
    ts_prev = np.concatenate([ts[1:], [-1]])
    t_rows, tp_rows = steps_on_device(ts), steps_on_device(ts_prev)
    for i, t in enumerate(ts.tolist()):
        eps, sc = call(x, t_rows[i], sc)
        x = ddim_step(
            sched, x, t_rows[i], tp_rows[i], eps, eta=eta,
            noise=noise_fn(t) if eta > 0.0 else None,
        )
    return x
