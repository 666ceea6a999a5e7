"""DDIM / DDPM samplers, driven step by step from Python.

The reference drives each denoising step from Python, switching the model
between full and sparse mode per step
(reference: diffusion/samplers/ddim_ddpm_sampler.py:60-73,
base_sampler.py:14-49); ``sige_tpu`` fuses the same loop into one
``lax.scan``. Here it is a Python loop over eager calls: each step runs
the full pass on the original-trajectory row (refreshing caches and
folded affines), then the sparse pass on the edited row, applies the
DDIM/DDPM update, and blends the outside-mask region back to the
ground-truth trajectory.

SDEdit semantics per step (reference: base_sampler.py:36-49):
  row 0 (original trajectory) is *replaced* by the deterministic
  ground-truth xt; row 1 keeps generated content only inside the
  difference mask.

Noise: each step draws ``randn`` from a ``torch.Generator``, or takes
step ``i`` of an explicit ``noise`` sequence (tests feed numpy noise).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..nn.engine import SIGEModel
from .diffusion import DiffusionSchedule


def _steps(seq):
    """[(t, t_next)] from the ascending sequence, largest t first."""
    seq = [int(s) for s in np.asarray(seq)]
    nxt = [-1] + seq[:-1]
    return list(zip(reversed(seq), reversed(nxt)))


class _BaseSampler:
    def __init__(self, schedule: DiffusionSchedule, eta: float = 0.0):
        self.schedule = schedule
        self.eta = eta  # DDIM only

    # ---- the per-step x-update; implemented by DDIM / DDPM ---------------
    def update(self, x, et, at, atm1, t: int, noise):
        raise NotImplementedError

    def q_sample(self, x0, t: int, e):
        return self.schedule.q_sample(x0, t, e)

    def _post_process(self, x, t_next: int, mask, gt_x0, gt_e):
        gt_xt = self.q_sample(gt_x0, t_next, gt_e)  # [1, H, W, C]
        m = mask[None, :, :, None].to(x.dtype)
        blended = gt_xt[0] * (1 - m[0]) + x[-1] * m[0]
        if x.shape[0] == 2:
            return torch.stack([gt_xt[0], blended], dim=0)
        return blended[None]

    def _noise(self, x, i: int, generator, noise):
        if noise is not None:
            return torch.as_tensor(noise[i], dtype=x.dtype, device=x.device)
        return torch.randn(x.shape, generator=generator, dtype=x.dtype,
                           device=x.device)

    # ---- public entry points --------------------------------------------
    @torch.inference_mode()
    def sample_sige(self, model: SIGEModel, xt, seq, mask, gt_x0, gt_e,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[Sequence] = None):
        """Run the full SDEdit trajectory for a SIGE model.

        Args:
          model: the engine, with caches filled and masks set (its planning
            needs one full pass anyway).
          xt: [2, H, W, C] noised (original, edited) at seq[-1].
          seq: [S] ascending timestep sequence.
          mask: [H, W] difference mask (bool tensor on the model's device).
          gt_x0 / gt_e: [1, H, W, C] ground-truth image / fixed noise.
          generator / noise: the sampler's stochastic terms (see module
            docstring).

        Returns: x0 [2, H, W, C].
        """
        x = xt
        for i, (t, t_next) in enumerate(_steps(seq)):
            tt = torch.full((x.shape[0],), float(t), device=x.device)
            at = self.schedule.alpha(t)
            atm1 = self.schedule.alpha(t_next)
            y0 = model.full(x[:1], tt[:1])
            y1 = model.sparse(x[1:], tt[1:])
            et = torch.cat([y0, y1], dim=0)
            x = self.update(x, et, at, atm1, t,
                            self._noise(x, i, generator, noise))
            x = self._post_process(x, t_next, mask, gt_x0, gt_e)
        return x

    @torch.inference_mode()
    def sample_dense(self, model: SIGEModel, xt, seq, mask, gt_x0, gt_e,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[Sequence] = None):
        """Dense-baseline trajectory (edited image only, batch 1;
        reference runs vanilla models this way: runner.py:203-205)."""
        x = xt
        for i, (t, t_next) in enumerate(_steps(seq)):
            tt = torch.full((x.shape[0],), float(t), device=x.device)
            at = self.schedule.alpha(t)
            atm1 = self.schedule.alpha(t_next)
            et = model.dense(x, tt)
            x = self.update(x, et, at, atm1, t,
                            self._noise(x, i, generator, noise))
            x = self._post_process(x, t_next, mask, gt_x0, gt_e)
        return x


class DDIMSampler(_BaseSampler):
    """Reference: diffusion/samplers/ddim_sampler.py:11-27."""

    def update(self, x, et, at, atm1, t, noise):
        x0_t = (x - et * torch.sqrt(1.0 - at)) / torch.sqrt(at)
        c1 = self.eta * torch.sqrt((1 - at / atm1) * (1 - atm1) / (1 - at))
        c2 = torch.sqrt((1 - atm1) - c1**2)
        return torch.sqrt(atm1) * x0_t + c1 * noise + c2 * et


class DDPMSampler(_BaseSampler):
    """Reference: diffusion/samplers/ddpm_sampler.py:11-32."""

    def update(self, x, et, at, atm1, t, noise):
        beta_t = 1 - at / atm1
        x0 = (x - et * torch.sqrt(1.0 - at)) / torch.sqrt(at)
        x0 = torch.clamp(x0, -1.0, 1.0)
        mean = (
            torch.sqrt(atm1) * beta_t * x0
            + torch.sqrt(1 - beta_t) * (1 - atm1) * x
        ) / (1.0 - at)
        nz_mask = 0.0 if int(t) == 0 else 1.0
        return mean + nz_mask * torch.exp(0.5 * torch.log(beta_t)) * noise
