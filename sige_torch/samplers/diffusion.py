"""Diffusion schedules and timestep sequences.

Matches the reference's β-schedule conventions
(reference: diffusion/samplers/ddim_ddpm_sampler.py:17-36) and its
sampling-sequence construction (reference: diffusion/runner.py:113-129).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def get_beta_schedule(
    beta_schedule: str, beta_start: float, beta_end: float, num_steps: int
) -> np.ndarray:
    if beta_schedule == "quad":
        betas = np.linspace(beta_start**0.5, beta_end**0.5, num_steps, dtype=np.float64) ** 2
    elif beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, num_steps, dtype=np.float64)
    elif beta_schedule == "const":
        betas = beta_end * np.ones(num_steps, dtype=np.float64)
    elif beta_schedule == "jsd":
        betas = 1.0 / np.linspace(num_steps, 1, num_steps, dtype=np.float64)
    elif beta_schedule == "sigmoid":
        s = np.linspace(-6, 6, num_steps)
        betas = 1.0 / (1.0 + np.exp(-s)) * (beta_end - beta_start) + beta_start
    else:
        raise NotImplementedError(beta_schedule)
    return betas


def get_sampling_sequence(
    sample_steps: int, noise_level: int, skip_type: str = "uniform"
) -> np.ndarray:
    """Ascending timestep sequence (reference: diffusion/runner.py:113-129)."""
    if skip_type == "uniform":
        skip = noise_level // sample_steps
        seq = np.arange(0, noise_level, skip)
    elif skip_type == "quad":
        seq = np.linspace(0, np.sqrt(noise_level * 0.8), sample_steps - 1) ** 2
        seq = np.concatenate([seq.astype(np.int64), [noise_level]])
    else:
        raise NotImplementedError(skip_type)
    return np.asarray(seq, np.int32)


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """β schedule with ᾱ lookup. ``alpha(t)`` returns the cumulative
    product ᾱ_t as a float32 0-dim CPU tensor (it mixes with tensors on
    any device without a transfer), with t = -1 mapping to 1 (the
    reference pads the β array with a leading zero;
    reference: ddim_ddpm_sampler.py:11-14)."""

    betas: torch.Tensor            # [T] float32
    alphas_cumprod: torch.Tensor   # [T + 1], alphas_cumprod[0] = 1

    @classmethod
    def create(cls, beta_schedule: str, beta_start: float, beta_end: float,
               total_steps: int) -> "DiffusionSchedule":
        betas64 = get_beta_schedule(beta_schedule, beta_start, beta_end, total_steps)
        acp = np.concatenate([[1.0], np.cumprod(1.0 - betas64)])
        return cls(
            betas=torch.as_tensor(betas64, dtype=torch.float32),
            alphas_cumprod=torch.as_tensor(acp, dtype=torch.float32),
        )

    def alpha(self, t: int) -> torch.Tensor:
        """ᾱ_t for integer t >= -1."""
        return self.alphas_cumprod[int(t) + 1]

    def q_sample(self, x0, t: int, e):
        """xt = sqrt(ᾱ_t) x0 + sqrt(1-ᾱ_t) e
        (reference: ddim_ddpm_sampler.py:55-58)."""
        a = self.alpha(t)
        return x0 * torch.sqrt(a) + e * torch.sqrt(1.0 - a)
