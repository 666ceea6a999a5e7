"""Multistep DPM-Solver / DPM-Solver++ (orders 1-3), driven from Python.

The port of ``sige_tpu.samplers.dpm_solver`` (behavioral parity with the
reference sampler; reference: diffusion/samplers/dpm_solver_sampler.py).
The timestep sequence is known up front, so every solver coefficient
(λ, σ, α, φ terms) is computed on the host in float64; each step is then
a few tensor multiply-adds on the device. ``sige_tpu`` unrolls the steps
into one jitted program; here they are a Python loop over eager calls,
as in :mod:`sige_torch.samplers.ddim_ddpm`.

The discrete-β VP noise schedule maps integer timesteps to continuous
labels ``(t + 1) / 1000 + 1 / N`` and piecewise-linearly interpolates
log ᾱ (with linear extrapolation at the ends, as the reference's
``interpolate_fn``; reference: dpm_solver_sampler.py:12-44).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..nn.engine import SIGEModel
from .ddim_ddpm import _BaseSampler
from .diffusion import DiffusionSchedule


class _DiscreteVPSchedule:
    """Host-side float64 noise schedule (reference: NoiseScheduleVP)."""

    def __init__(self, betas: np.ndarray):
        log_alphas = 0.5 * np.cumsum(np.log(1.0 - np.asarray(betas, np.float64)))
        # numerical_clip_alpha: drop tail entries with log-SNR < -5.1
        log_sigmas = 0.5 * np.log(1.0 - np.exp(2.0 * log_alphas))
        lambs = log_alphas - log_sigmas
        n_clip = int(np.searchsorted(lambs[::-1], -5.1))
        if n_clip > 0:
            log_alphas = log_alphas[:-n_clip]
        self.log_alpha_array = log_alphas
        self.total_N = log_alphas.shape[0]
        self.t_array = np.linspace(0.0, 1.0, self.total_N + 1)[1:]

    def _interp(self, t: float) -> float:
        """Piecewise-linear with end extrapolation."""
        xp, yp = self.t_array, self.log_alpha_array
        if t <= xp[0]:
            i = 0
        elif t >= xp[-1]:
            i = len(xp) - 2
        else:
            i = int(np.searchsorted(xp, t)) - 1
        x0, x1 = xp[i], xp[i + 1]
        y0, y1 = yp[i], yp[i + 1]
        return float(y0 + (t - x0) * (y1 - y0) / (x1 - x0))

    def log_alpha(self, t: float) -> float:
        return self._interp(t)

    def sigma(self, t: float) -> float:
        return float(np.sqrt(1.0 - np.exp(2.0 * self.log_alpha(t))))

    def lam(self, t: float) -> float:
        la = self.log_alpha(t)
        return float(la - 0.5 * np.log(1.0 - np.exp(2.0 * la)))


class DPMSolverSampler(_BaseSampler):
    """SDEdit sampler using multistep DPM-Solver(++); the model's
    prediction is turned into an x0 (data) prediction each step."""

    def __init__(self, schedule: DiffusionSchedule,
                 algorithm_type: str = "dpmsolver++", order: int = 2,
                 solver_type: str = "dpmsolver",
                 lower_order_final: bool = True):
        if algorithm_type not in ("dpmsolver", "dpmsolver++"):
            raise ValueError(f"algorithm_type {algorithm_type!r}")
        if solver_type not in ("dpmsolver", "taylor"):
            raise ValueError(f"solver_type {solver_type!r}")
        if order not in (1, 2, 3):
            raise ValueError(f"order {order}")
        super().__init__(schedule)
        self.algorithm_type = algorithm_type
        self.order = order
        self.solver_type = solver_type
        self.lower_order_final = lower_order_final
        self._ns = _DiscreteVPSchedule(schedule.betas.numpy())

    def _t_cont(self, t_int: int) -> float:
        return (t_int + 1) / 1000 + 1 / self._ns.total_N

    # ---- single-step updates with host-computed coefficients -------------
    def _update(self, x, model_prevs: List, t_prevs: List[float],
                t: float, order: int):
        ns = self._ns
        lam_t = ns.lam(t)
        log_a_t = ns.log_alpha(t)
        sigma_t = ns.sigma(t)
        alpha_t = float(np.exp(log_a_t))
        t0 = t_prevs[-1]
        lam0, log_a0, sigma0 = ns.lam(t0), ns.log_alpha(t0), ns.sigma(t0)
        h = lam_t - lam0
        pp = self.algorithm_type == "dpmsolver++"
        m0 = model_prevs[-1]

        if order == 1:
            if pp:
                phi1 = float(np.expm1(-h))
                return (sigma_t / sigma0) * x - (alpha_t * phi1) * m0
            phi1 = float(np.expm1(h))
            return float(np.exp(log_a_t - log_a0)) * x - (sigma_t * phi1) * m0

        m1 = model_prevs[-2]
        t1 = t_prevs[-2]
        lam1 = ns.lam(t1)
        h0 = lam0 - lam1
        r0 = h0 / h
        D1_0 = (1.0 / r0) * (m0 - m1)

        if order == 2:
            if pp:
                phi1 = float(np.expm1(-h))
                if self.solver_type == "dpmsolver":
                    return ((sigma_t / sigma0) * x - (alpha_t * phi1) * m0
                            - 0.5 * (alpha_t * phi1) * D1_0)
                return ((sigma_t / sigma0) * x - (alpha_t * phi1) * m0
                        + (alpha_t * (phi1 / h + 1.0)) * D1_0)
            phi1 = float(np.expm1(h))
            if self.solver_type == "dpmsolver":
                return (float(np.exp(log_a_t - log_a0)) * x
                        - (sigma_t * phi1) * m0 - 0.5 * (sigma_t * phi1) * D1_0)
            return (float(np.exp(log_a_t - log_a0)) * x
                    - (sigma_t * phi1) * m0 - (sigma_t * (phi1 / h - 1.0)) * D1_0)

        # order == 3
        m2 = model_prevs[-3]
        t2 = t_prevs[-3]
        lam2 = ns.lam(t2)
        h1 = lam1 - lam2
        r1 = h1 / h
        D1_1 = (1.0 / r1) * (m1 - m2)
        D1 = D1_0 + (r0 / (r0 + r1)) * (D1_0 - D1_1)
        D2 = (1.0 / (r0 + r1)) * (D1_0 - D1_1)
        if pp:
            phi1 = float(np.expm1(-h))
            phi2 = phi1 / h + 1.0
            phi3 = phi2 / h - 0.5
            return ((sigma_t / sigma0) * x - (alpha_t * phi1) * m0
                    + (alpha_t * phi2) * D1 - (alpha_t * phi3) * D2)
        phi1 = float(np.expm1(h))
        phi2 = phi1 / h - 1.0
        phi3 = phi2 / h - 0.5
        return (float(np.exp(log_a_t - log_a0)) * x - (sigma_t * phi1) * m0
                - (sigma_t * phi2) * D1 - (sigma_t * phi3) * D2)

    # ---- model step: x0-prediction (data prediction) ---------------------
    def data_prediction(self, x, et, t_int: int):
        """The x0 that the noise prediction ``et`` at ``t_int`` implies."""
        at = self.schedule.alpha(t_int)
        return (x - et * torch.sqrt(1.0 - at)) / torch.sqrt(at)

    def _model_step(self, model: SIGEModel, x, t_int: int, sige: bool):
        t = torch.full((x.shape[0],), float(t_int), device=x.device)
        if sige:
            et = torch.cat([model.full(x[:1], t[:1]),
                            model.sparse(x[1:], t[1:])], dim=0)
        else:
            et = model.dense(x, t)
        return self.data_prediction(x, et, t_int)

    # ---- full trajectory (DPM-Solver uses ~5 steps) ----------------------
    def trajectory(self, model_step, xt, seq, mask, gt_x0, gt_e):
        """The multistep solver from ``xt`` down the ascending ``seq``.
        ``model_step(x, t_int, step)`` gives the data prediction of model
        evaluation ``step`` (0 .. len(seq) - 1) at timestep ``t_int``;
        after each update the SDEdit blend keeps ``x`` inside ``mask``
        only (None: no blend)."""
        seq = [int(s) for s in np.asarray(seq)]
        steps = len(seq)
        order = self.order
        rev = list(reversed([-1] + seq))  # [t_S, ..., t_1, -1]

        x = xt
        t_prevs: List[float] = []
        model_prevs: List = []
        for step, t_int in enumerate(rev):
            t_c = self._t_cont(t_int)
            if step == 0:
                t_prevs = [t_c]
                model_prevs = [model_step(x, t_int, 0)]
                continue
            if step < order:
                step_order = step
            elif self.lower_order_final and steps < 10:
                step_order = min(order, steps + 1 - step)
            else:
                step_order = order
            x = self._update(x, model_prevs, t_prevs, t_c, step_order)
            if mask is not None:
                x = self._post_process(x, t_int, mask, gt_x0, gt_e)
            t_prevs.append(t_c)
            if len(t_prevs) > order:
                t_prevs.pop(0)
                model_prevs.pop(0)
            if step < steps:
                model_prevs.append(model_step(x, t_int, step))
        return x

    @torch.inference_mode()
    def sample_sige(self, model: SIGEModel, xt, seq, mask, gt_x0, gt_e,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[Sequence] = None):
        """The SDEdit twin trajectory for a SIGE model (arguments as
        :meth:`~sige_torch.samplers.ddim_ddpm._BaseSampler.sample_sige`;
        the solver draws no noise, so ``generator`` and ``noise`` are
        unused). Returns x0 [2, H, W, C]."""
        return self.trajectory(
            lambda x, t, _: self._model_step(model, x, t, True), xt, seq,
            mask, gt_x0, gt_e)

    @torch.inference_mode()
    def sample_dense(self, model: SIGEModel, xt, seq, mask, gt_x0, gt_e,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[Sequence] = None):
        """Dense-baseline trajectory (edited image only, batch 1)."""
        return self.trajectory(
            lambda x, t, _: self._model_step(model, x, t, False), xt, seq,
            mask, gt_x0, gt_e)
