"""Diffusion schedules, the SDEdit samplers and the SD DDIM sampler."""

from .ddim_ddpm import DDIMSampler, DDPMSampler
from .dpm_solver import DPMSolverSampler
from .sd_ddim import SDDDIMSampler
from .diffusion import (DiffusionSchedule, get_beta_schedule,
                        get_sampling_sequence)

__all__ = ["DDIMSampler", "DDPMSampler", "DPMSolverSampler", "SDDDIMSampler",
           "DiffusionSchedule",
           "get_beta_schedule", "get_sampling_sequence"]
