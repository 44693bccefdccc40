"""Diffusion math shared by every workload: schedules and reverse steps."""

from tinydiffusionmodels_torch.core.diffusion import (
    ddim_step,
    ddpm_loss,
    eps_from_x0,
    p_sample,
    p_sample_mean,
    q_sample,
)
from tinydiffusionmodels_torch.core.schedule import (
    DiffusionSchedule,
    make_schedule,
)

__all__ = [
    "DiffusionSchedule",
    "ddim_step",
    "ddpm_loss",
    "eps_from_x0",
    "make_schedule",
    "p_sample",
    "p_sample_mean",
    "q_sample",
]
