"""Progressive Distillation sampler (x / eps hybrid prediction, logsnr
schedule) — the port of ``sige_tpu.samplers.pd``
(reference: diffusion/samplers/pd_sampler.py).

The model emits 6 channels: an x0 prediction and an eps prediction,
blended by sigma^2 weighting, clipped, then stepped deterministically
(DDIM-style in the logsnr parameterization). ``sige_tpu`` fuses the
few-step trajectory into one ``lax.scan``; here it is a Python loop over
eager calls, as in :mod:`sige_torch.samplers.ddim_ddpm`: each step runs
the full pass on the original-trajectory row and the sparse pass on the
edited row, takes ``x_pred`` at the last step (i = 0) and ``z_s``
before it, and blends the outside-mask region back to the ground-truth
trajectory. The sampler draws no noise of its own: the caller's noise
(from a ``torch.Generator``) enters through ``q_sample`` and ``gt_e``.
"""

from __future__ import annotations

import math

import torch

from ..nn.engine import SIGEModel
from .ddim_ddpm import _steps, sdedit_blend

LOGSNR_MIN, LOGSNR_MAX = -20.0, 20.0


def logsnr_schedule(t) -> torch.Tensor:
    """Cosine logsnr schedule over u in [0, 1], float32 on the CPU for a
    scalar or a sequence (reference: pd_sampler.py:11-14)."""
    b = math.atan(math.exp(-0.5 * LOGSNR_MAX))
    a = math.atan(math.exp(-0.5 * LOGSNR_MIN)) - b
    return -2.0 * torch.log(torch.tan(
        a * torch.as_tensor(t, dtype=torch.float32) + b))


class PDSampler:
    """``total_steps``: the distilled model's step count (the logsnr of
    step t is ``logsnr_schedule((t + 1) / total_steps)``)."""

    def __init__(self, total_steps: int = 8):
        self.total_steps = total_steps

    def logsnr(self, t: int) -> torch.Tensor:
        return logsnr_schedule((float(t) + 1) / self.total_steps)

    def q_sample(self, x0, t: int, e):
        """z_t with logsnr((t + 1) / total) (reference:
        pd_sampler.py:71-79)."""
        logsnr = self.logsnr(t)
        alpha = torch.sqrt(torch.sigmoid(logsnr))
        std = torch.sqrt(torch.sigmoid(-logsnr))
        return x0 * alpha + e * std

    @staticmethod
    def _predict(z, model_output, logsnr):
        """Blend the x0 / eps heads (reference: pd_sampler.py:27-64)."""
        _x, _eps = model_output.chunk(2, dim=-1)
        x_from_eps = torch.sqrt(1.0 + torch.exp(-logsnr)) * (
            z - _eps / torch.sqrt(1.0 + torch.exp(logsnr)))
        wx = torch.sigmoid(-logsnr)
        x = torch.clamp(wx * _x + (1.0 - wx) * x_from_eps, -1.0, 1.0)
        eps = torch.sqrt(1.0 + torch.exp(logsnr)) * (
            z - x / torch.sqrt(1.0 + torch.exp(-logsnr)))
        return x, eps

    def _post_process(self, x, t_next: int, mask, gt_x0, gt_e):
        return sdedit_blend(x, self.q_sample(gt_x0, t_next, gt_e), mask)

    def _step(self, x, out, t: int, t_next: int):
        logsnr_t, logsnr_s = self.logsnr(t), self.logsnr(t_next)
        x_pred, eps_pred = self._predict(x, out, logsnr_t)
        if t == 0:
            return x_pred
        return (torch.sqrt(torch.sigmoid(logsnr_s)) * x_pred
                + torch.sqrt(torch.sigmoid(-logsnr_s)) * eps_pred)

    @torch.inference_mode()
    def sample_sige(self, model: SIGEModel, xt, seq, mask, gt_x0, gt_e):
        """The SDEdit twin trajectory for a SIGE model.

        Args:
          model: the engine, with caches filled and masks set.
          xt: [2, H, W, C] noised (original, edited) at seq[-1].
          seq: [S] ascending step sequence.
          mask: [H, W] difference mask (bool tensor on the model's device).
          gt_x0 / gt_e: [1, H, W, C] ground-truth image / fixed noise.

        Returns: x0 [2, H, W, C]."""
        x = xt
        for t, t_next in _steps(seq):
            ls = self.logsnr(t).reshape(1).to(x.device)
            out = torch.cat([model.full(x[:1], ls), model.sparse(x[1:], ls)])
            x = self._post_process(self._step(x, out, t, t_next), t_next,
                                   mask, gt_x0, gt_e)
        return x

    @torch.inference_mode()
    def sample_dense(self, model: SIGEModel, xt, seq, mask, gt_x0, gt_e):
        """Dense-baseline trajectory over ``xt``'s batch."""
        x = xt
        for t, t_next in _steps(seq):
            ls = self.logsnr(t).expand(x.shape[0]).to(x.device)
            out = model.dense(x, ls)
            x = self._post_process(self._step(x, out, t, t_next), t_next,
                                   mask, gt_x0, gt_e)
        return x
