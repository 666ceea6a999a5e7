"""Stable Diffusion DDIM sampler: classifier-free guidance, the latent
inpainting blend, and the twin-trajectory SIGE img2img decode — the port
of ``sige_tpu.samplers.sd_ddim``.

Reference: stable-diffusion/ldm/models/diffusion/ddim.py +
ldm/modules/diffusionmodules/util.py:42-72. The per-index schedule
coefficients are computed on the host in float64 and kept as float32, as
in ``sige_tpu``; each flow, a ``lax.scan`` there, is a Python loop over
the engine's ``full`` / ``sparse`` / ``dense`` calls here.

Noise (the inpainting blend's ``q_sample``) comes from a
``torch.Generator`` or, step by step, from an explicit sequence (tests
feed ``sige_tpu``'s noise).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..nn.engine import SIGEModel


def sd_beta_schedule(linear_start=0.00085, linear_end=0.0120, n=1000):
    """ldm's "linear" schedule is sqrt-linear
    (reference: ldm/modules/diffusionmodules/util.py make_beta_schedule)."""
    return np.linspace(linear_start**0.5, linear_end**0.5, n,
                       dtype=np.float64) ** 2


def make_ddim_timesteps(num_ddim_steps: int, num_ddpm_steps: int = 1000,
                        method: str = "uniform") -> np.ndarray:
    if method == "uniform":
        c = num_ddpm_steps // num_ddim_steps
        ts = np.arange(0, num_ddpm_steps, c)
    elif method == "quad":
        ts = (np.linspace(0, np.sqrt(num_ddpm_steps * 0.8),
                          num_ddim_steps) ** 2).astype(int)
    else:
        raise NotImplementedError(method)
    return ts + 1  # reference: util.py:53


class SDDDIMSampler:
    """DDIM over the SD discrete schedule."""

    def __init__(self, num_steps: int = 50, eta: float = 0.0,
                 guidance_scale: float = 7.5, linear_start: float = 0.00085,
                 linear_end: float = 0.0120, ddpm_steps: int = 1000):
        self.num_steps, self.eta = num_steps, eta
        self.guidance_scale = guidance_scale
        betas = sd_beta_schedule(linear_start, linear_end, ddpm_steps)
        acp = np.cumprod(1.0 - betas)
        ts = make_ddim_timesteps(num_steps, ddpm_steps)
        alphas = acp[ts]
        alphas_prev = np.concatenate([[acp[0]], acp[ts[:-1]]])
        sigmas = eta * np.sqrt(
            (1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
        self.timesteps = ts.astype(np.int32)
        self.alphas_cumprod = acp.astype(np.float32)
        self.ddim_alphas = alphas.astype(np.float32)
        self.ddim_alphas_prev = alphas_prev.astype(np.float32)
        self.ddim_sigmas = sigmas.astype(np.float32)

    # ------------------------------------------------------------------
    def q_sample(self, x0, t: int, noise):
        a = float(self.alphas_cumprod[t])
        return math.sqrt(a) * x0 + math.sqrt(1.0 - a) * noise

    def stochastic_encode(self, x0, index: int, noise):
        """Noise x0 to DDIM step ``index`` (reference: ddim.py:293-308)."""
        a = float(self.ddim_alphas[index])
        return math.sqrt(a) * x0 + math.sqrt(1.0 - a) * noise

    # ------------------------------------------------------------------
    def _apply_model(self, model: SIGEModel, x, t, uc, c, mode: str):
        """Classifier-free guidance through one double-batch call
        (reference: ddim.py:252-259): x [B, H, W, C], contexts uc / c
        [B, seq, d]. In ``full`` mode the call refreshes the caches, which
        hold the uncond and cond halves (reference: ddim.py:183-201)."""
        fwd = {"full": model.full, "sparse": model.sparse,
               "dense": model.dense}[mode]
        if self.guidance_scale == 1.0 or uc is None:
            return fwd(x, t, c)
        out = fwd(torch.cat([x, x]), torch.cat([t, t]), torch.cat([uc, c]))
        e_uncond, e_cond = out.chunk(2)
        return e_uncond + self.guidance_scale * (e_cond - e_uncond)

    def _step(self, x, e_t, index: int):
        a_t = float(self.ddim_alphas[index])
        a_prev = float(self.ddim_alphas_prev[index])
        sigma_t = float(self.ddim_sigmas[index])
        pred_x0 = (x - math.sqrt(1.0 - a_t) * e_t) / math.sqrt(a_t)
        dir_xt = math.sqrt(1.0 - a_prev - sigma_t**2) * e_t
        return math.sqrt(a_prev) * pred_x0 + dir_xt  # eta=0: no noise term

    def _schedule(self, n: int):
        """[(timestep, index)] of the first ``n`` DDIM steps, last first."""
        return [(int(self.timesteps[i]), i) for i in reversed(range(n))]

    @staticmethod
    def _t(x, step: int):
        return torch.full((x.shape[0],), float(step), device=x.device)

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def inpaint_sige(self, model: SIGEModel, img, x0, blend_mask, uc, c,
                     total_steps: int,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[Sequence] = None):
        """Latent inpainting (reference: ddim.py:160-230): per step blend
        ``img = q_sample(x0) * blend_mask + img * (1 - blend_mask)``
        (``blend_mask`` = the region to keep; each step's ``q_sample``
        draws fresh noise, or takes ``noise[i]``), refresh the caches with
        a full pass on the noised original, then a sparse step of the
        image. Returns the samples."""
        for i, (step, index) in enumerate(self._schedule(total_steps)):
            t = self._t(img, step)
            eps = (torch.as_tensor(noise[i], dtype=x0.dtype, device=x0.device)
                   if noise is not None else
                   torch.randn(x0.shape, generator=generator, dtype=x0.dtype,
                               device=x0.device))
            img_orig = self.q_sample(x0, step, eps)
            img = img_orig * blend_mask + (1.0 - blend_mask) * img
            self._apply_model(model, img_orig, t, uc, c, "full")
            e_t = self._apply_model(model, img, t, uc, c, "sparse")
            img = self._step(img, e_t, index)
        return img

    @torch.inference_mode()
    def img2img_decode_sige(self, model: SIGEModel, x_init, x_edited, uc, c,
                            t_start: int):
        """Twin-trajectory SIGE img2img (reference: ddim.py:345-393): each
        step the full pass on the init trajectory refreshes the caches,
        then the sparse pass steps the edited one. Returns (x_init,
        x_edited)."""
        for step, index in self._schedule(t_start):
            t = self._t(x_init, step)
            e_init = self._apply_model(model, x_init, t, uc, c, "full")
            x_init = self._step(x_init, e_init, index)
            e_edit = self._apply_model(model, x_edited, t, uc, c, "sparse")
            x_edited = self._step(x_edited, e_edit, index)
        return x_init, x_edited

    @torch.inference_mode()
    def decode_dense(self, model: SIGEModel, x, uc, c, t_start: int):
        """Dense img2img decode (reference: ddim.py:310-342)."""
        for step, index in self._schedule(t_start):
            e_t = self._apply_model(model, x, self._t(x, step), uc, c,
                                    "dense")
            x = self._step(x, e_t, index)
        return x
