"""Diffusion schedules and SDEdit samplers."""

from .ddim_ddpm import DDIMSampler, DDPMSampler
from .diffusion import (DiffusionSchedule, get_beta_schedule,
                        get_sampling_sequence)

__all__ = ["DDIMSampler", "DDPMSampler", "DiffusionSchedule",
           "get_beta_schedule", "get_sampling_sequence"]
