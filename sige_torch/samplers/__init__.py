"""Diffusion schedules and SDEdit samplers."""

from .ddim_ddpm import DDIMSampler, DDPMSampler
from .dpm_solver import DPMSolverSampler
from .diffusion import (DiffusionSchedule, get_beta_schedule,
                        get_sampling_sequence)

__all__ = ["DDIMSampler", "DDPMSampler", "DPMSolverSampler",
           "DiffusionSchedule",
           "get_beta_schedule", "get_sampling_sequence"]
