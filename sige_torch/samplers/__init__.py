"""Diffusion schedules, the SDEdit samplers (DDIM/DDPM, DPM-Solver,
Progressive Distillation) and the SD DDIM sampler."""

from .ddim_ddpm import DDIMSampler, DDPMSampler
from .dpm_solver import DPMSolverSampler
from .pd import PDSampler, logsnr_schedule
from .sd_ddim import SDDDIMSampler
from .diffusion import (DiffusionSchedule, get_beta_schedule,
                        get_sampling_sequence)

__all__ = ["DDIMSampler", "DDPMSampler", "DPMSolverSampler", "PDSampler",
           "SDDDIMSampler", "DiffusionSchedule", "logsnr_schedule",
           "get_beta_schedule", "get_sampling_sequence"]
