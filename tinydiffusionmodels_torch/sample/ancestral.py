"""The reverse-diffusion sampling loop (port of ``sample/ancestral.py``).

The JAX package's ``lax.scan``s become a ``Sampler``, a loop of steps on
device state: x and the self-conditioning carry ``sc`` (and
DPM-Solver++'s previous x0 and log-SNR step) live in buffers that each
step updates in place, and a step reads its timestep row and coefficients
from device tables by a device step index that it advances. Nothing in a
step reads a device value on the host, so on the card each kind of step
(the ancestral step, the DDIM step, DPM-Solver++'s first- and
second-order steps) is captured as a CUDA graph and replayed
(``graphs.py``), the per-step noise drawn inside the graph
(``ops.rng``). A ``Sampler`` keeps its graphs, so calling it again
replays every step; ``sample_loop`` is one call of a new one. On the CPU,
or with ``eager=True``, the same steps run eagerly: that is the plain
version a replay is held against.

Randomness is the JAX sampler's (``core/rng.py``): a call's ``key`` splits
into (init_key, loop_key), x_T is ``normal(init_key)`` and step t's noise
``normal(fold_in(loop_key, t))``, t the timestep, which the step reads
from its device table: the loop key lies in a device buffer, so one graph
serves every call and key. An explicit ``x_T`` and a per-step
``noise_fn(t)`` (a host callback, which a graph cannot call: on the card
it needs ``eager=True``) replace the draws.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from tinydiffusionmodels_torch import graphs, ops
from tinydiffusionmodels_torch.core import rng
from tinydiffusionmodels_torch.core.diffusion import ddim_step, p_sample
from tinydiffusionmodels_torch.core.schedule import DiffusionSchedule

DenoiseFn = Callable[..., torch.Tensor]
NoiseFn = Callable[[int], torch.Tensor]


# Eager steps of each kind on a side stream before its capture.
WARMUP = 1


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
    key=None,
    x_T: torch.Tensor | None = None,
    noise_fn: NoiseFn | None = None,
    eager: bool = False,
) -> torch.Tensor:
    """Run the full reverse process from N(0, I) noise on ``sched``'s device:
    one call of a ``Sampler`` made for it (see there). A caller that samples
    the same configuration again keeps a ``Sampler``, whose graphs are
    captured once."""
    return Sampler(denoise_fn, sched, shape, method=method,
                   num_steps=num_steps, eta=eta, self_cond=self_cond,
                   temperature=temperature, eager=eager)(
                       key, x_T=x_T, noise_fn=noise_fn)


class Sampler:
    """One configuration of the reverse process, run as often as called.

    denoise_fn: (x_t, t) -> eps_hat; with ``self_cond`` it is (x_t, t,
    x0_prev) -> (eps_hat, x0_est), and x0_est is carried to the next step
    (zeros at the first).
    method 'ancestral': DDPM, sched.timesteps steps (reference parity).
    method 'ddim': ``num_steps`` strided DDIM steps (default 50).
    method 'dpm++': DPM-Solver++(2M), ``num_steps`` steps (default 20).
    ``temperature`` scales the ancestral path's injected noise; with the
    deterministic solvers anything but 1 is rejected, not ignored.

    It holds the loop's device state (x, the carry, DPM-Solver++'s previous
    x0 and log-SNR step, the step index) and tables, and on the card one
    ``graphs.Step`` per kind of step: the first time a kind runs it runs
    eagerly, the next time it is captured, then replayed, so a second call
    replays every step. Each call draws from its key (default: the
    ``key`` the sampler was made with). ``eager=True`` runs
    every step eagerly on the card too, instead of replaying its graph.
    """

    def __init__(self, denoise_fn: DenoiseFn, sched: DiffusionSchedule,
                 shape: tuple[int, ...], *, method: str = "ancestral",
                 num_steps: int | None = None, eta: float = 0.0,
                 self_cond: bool = False, temperature: float = 1.0,
                 key=None, eager: bool = False):
        if temperature != 1.0 and method != "ancestral":
            raise ValueError(
                f"temperature={temperature} has no effect with method="
                f"'{method}': dpm++ is deterministic and ddim's noise knob "
                "is eta. Use method='ancestral' (or eta for ddim)."
            )
        if method not in ("ancestral", "ddim", "dpm++"):
            raise ValueError(f"unknown sampling method: {method!r}")
        self.denoise_fn, self.sched, self.shape = denoise_fn, sched, shape
        self.key = key
        self.draws_noise = method == "ancestral" or (
            method == "ddim" and eta > 0.0)
        self.device = device = sched.betas.device
        self.eager = eager or device.type != "cuda"
        self.noise_fn = None
        self.steps = []   # the graphs.Step of each kind of step, on the card
        with torch.inference_mode():
            self.x = torch.empty(shape, device=device)
            self.sc = torch.zeros(shape, device=device) if self_cond else None
            self.i = torch.zeros((1,), dtype=torch.long, device=device)
            self.loop_key = torch.zeros((2,), dtype=torch.long,
                                        device=device)
            # The step of each index, k -> run(k).
            self.schedule = getattr(self, f"_{method.replace('+', 'p')}")(
                num_steps, eta, temperature)

    def __call__(self, key=None, x_T: torch.Tensor | None = None,
                 noise_fn: NoiseFn | None = None) -> torch.Tensor:
        """Samples from ``x_T`` (default: ``normal(split(key)[0])``), each
        step's noise from ``noise_fn`` (eager only) or the key."""
        key = self.key if key is None else key
        if key is None and (
                x_T is None or (self.draws_noise and noise_fn is None)):
            raise ValueError(
                "pass a key, or x_T (and noise_fn for a stochastic "
                "sampler): the sampler draws from no global RNG"
            )
        if noise_fn is not None and self.draws_noise and not self.eager:
            raise ValueError(
                "noise_fn is a host callback, which a CUDA graph cannot "
                "call; pass eager=True to run the steps eagerly on the card"
            )
        with torch.inference_mode():
            self.noise_fn = noise_fn
            if key is not None:
                init_key, loop_key = rng.split(rng.resolve(key))
                self.loop_key.copy_(loop_key)
            self.x.copy_(
                ops.rng.normal(init_key.to(self.device), self.shape)
                if x_T is None
                else x_T.to(device=self.device, dtype=torch.float32))
            if self.sc is not None:
                self.sc.zero_()
            self.i.zero_()
            for k, run in enumerate(self.schedule):
                run(k)
            return self.x.clone()

    def noise(self, t: int | None, t_b: torch.Tensor) -> torch.Tensor:
        """The step's noise: ``noise_fn(t)`` (eager only), else
        ``normal(fold_in(loop_key, t))`` with t read from ``t_b``."""
        if self.noise_fn is not None:
            return self.noise_fn(t)
        return ops.rng.normal(rng.KeyPath(self.loop_key, t_b[:1]),
                              self.shape)

    def rows(self, ts: np.ndarray) -> torch.Tensor:
        """(n,) host timesteps -> (n, batch) device rows, one per step."""
        rows = torch.as_tensor(np.ascontiguousarray(ts), dtype=torch.long)
        return rows.to(self.device)[:, None].expand(len(ts), self.shape[0])

    def at(self, table: torch.Tensor, offset: int = 0) -> torch.Tensor:
        """Row ``i + offset`` of a device table (a 0-d tensor for a 1-D
        table)."""
        index = self.i if offset == 0 else self.i + offset
        return table.index_select(0, index).squeeze(0)

    def denoise(self, t_b: torch.Tensor) -> torch.Tensor:
        """eps at the step's timesteps; updates the self-conditioning carry."""
        if self.sc is None:
            return self.denoise_fn(self.x, t_b)
        eps, x0_est = self.denoise_fn(self.x, t_b, self.sc)
        self.sc.copy_(x0_est)
        return eps

    def runner(self, step):
        """``step(k)`` for host step ``k``: eagerly, or a graph of
        ``step(None)`` replayed on the card (its noise drawn there)."""
        if self.eager:
            return step
        graph = graphs.Step(lambda: step(None), self.device, warmup=WARMUP)
        self.steps.append(graph)
        return lambda k: graph()

    def _ancestral(self, num_steps, eta, temperature) -> list:
        sched, x = self.sched, self.x
        ts = np.arange(sched.timesteps - 1, -1, -1)
        t_rows = self.rows(ts)

        def step(k):
            t_b = self.at(t_rows)
            eps = self.denoise(t_b)
            noise = self.noise(None if k is None else int(ts[k]), t_b)
            x.copy_(p_sample(sched, x, t_b, eps, noise,
                             noise_scale=temperature))
            self.i.add_(1)

        return [self.runner(step)] * len(ts)

    def _dpmpp(self, num_steps, eta, temperature) -> list:
        # DPM-Solver++(2M) (Lu et al. 2022): second-order multistep in
        # log-SNR space on the data prediction.
        sched, x = self.sched, self.x
        n = num_steps or 20
        ts = np.linspace(0, sched.timesteps - 1, n + 1).round().astype(
            np.int64
        )[::-1]
        t_rows = self.rows(ts)
        acp = sched.alphas_cumprod[t_rows[:, 0]]
        alphas = torch.sqrt(acp)
        sigmas = torch.sqrt(torch.clamp(1.0 - acp, min=1e-12))
        lams = torch.log(alphas / sigmas)
        x0_prev = torch.zeros_like(x)
        h_prev = torch.zeros((), device=self.device)

        def step(first):
            eps = self.denoise(self.at(t_rows))
            a_cur, s_cur = self.at(alphas), self.at(sigmas)
            a_nxt, s_nxt = self.at(alphas, 1), self.at(sigmas, 1)
            x0 = (x - s_cur * eps) / a_cur
            h = self.at(lams, 1) - self.at(lams)
            if first:  # first step: first-order update
                d = x0
            else:
                d = x0 + (0.5 / (h_prev / h)) * (x0 - x0_prev)
            x.copy_((s_nxt / s_cur) * x - a_nxt * torch.expm1(-h) * d)
            x0_prev.copy_(x0)
            h_prev.copy_(h)
            self.i.add_(1)

        first_order = self.runner(lambda k: step(True))
        second_order = self.runner(lambda k: step(False))
        return [first_order] + [second_order] * (n - 1)

    def _ddim(self, num_steps, eta, temperature) -> list:
        sched, x = self.sched, self.x
        n = num_steps or 50
        # Strided ladder t_i = round(i * T / n), descending; the final t_prev
        # of -1 means "emit x0_hat".
        ts = np.linspace(0, sched.timesteps - 1, n).round().astype(
            np.int64)[::-1]
        ts_prev = np.concatenate([ts[1:], [-1]])
        t_rows, tp_rows = self.rows(ts), self.rows(ts_prev)

        def step(k):
            t_b = self.at(t_rows)
            eps = self.denoise(t_b)
            noise = (self.noise(None if k is None else int(ts[k]), t_b)
                     if eta > 0.0 else None)
            x.copy_(ddim_step(sched, x, t_b, self.at(tp_rows), eps, eta=eta,
                              noise=noise))
            self.i.add_(1)

        return [self.runner(step)] * n
