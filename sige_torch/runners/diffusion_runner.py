"""Diffusion (SDEdit) runner: preprocess -> generate / profile.

The reference flow (reference: diffusion/runner.py:149-246): compute the
difference mask from the original/edited pair, dilate, pre-run the model
in full mode to record shapes, build the mask pyramid down to the
bottleneck resolution, set masks, then for each denoising step run the
full pass on the original trajectory and the sparse pass on the edited
one (:mod:`sige_torch.samplers.ddim_ddpm`,
:mod:`sige_torch.samplers.dpm_solver`). ``profile`` times one forward
with CUDA events and counts its analytic MACs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..core.masks import compute_difference_mask, dilate_mask, downsample_mask
from ..models.ddpm import DDPMUNetConfig, SIGEFusedUNet
from ..nn.engine import SIGEModel, fp32_scope, resolve_device
from ..nn.module import SIGECtx
from ..samplers import (DDIMSampler, DDPMSampler, DiffusionSchedule,
                        DPMSolverSampler, get_sampling_sequence)
from .common import memory_entry


@dataclasses.dataclass(frozen=True)
class DiffusionRunConfig:
    """Sampling config (church256 defaults;
    reference: diffusion/configs/church_ddpm256-sige.yml sampling section)."""

    sampler_type: str = "ddpm"          # "ddpm" | "ddim" | "dpm_solver"
    total_steps: int = 1000
    sample_steps: int = 500
    noise_level: int = 500
    beta_schedule: str = "linear"
    beta_start: float = 1e-4
    beta_end: float = 2e-2
    eta: float = 0.0                     # ddim
    skip_type: str = "uniform"
    eps: float = 1e-2                    # difference-mask threshold
    mask_dilate_radius: int = 5
    rescaled: bool = True                # data in [0,1] -> [-1,1]
    # dpm_solver knobs (reference: configs/church_dpmsolver256-sige.yml)
    algorithm_type: str = "dpmsolver++"
    order: int = 2
    solver_type: str = "dpmsolver"
    lower_order_final: bool = True


def data_transform(x: np.ndarray, rescaled: bool) -> np.ndarray:
    return 2.0 * x - 1.0 if rescaled else x


def inverse_data_transform(x: np.ndarray, rescaled: bool) -> np.ndarray:
    return np.clip((x + 1.0) / 2.0 if rescaled else x, 0.0, 1.0)


class DiffusionRunner:
    """Drives a SIGE DDPM U-Net through SDEdit generation/profiling.

    ``params`` is a state dict for the U-Net (e.g. from
    :func:`sige_torch.utils.from_jax.state_dict_from_flax`); without one
    the weights are drawn from ``seed``. ``device=None`` means the GPU and
    raises when there is none. ``layout="auto"`` (the default, as in
    ``sige_tpu``) picks the window or tile layout per edit;
    ``active_layout`` says which the last edit ran."""

    def __init__(self, model_cfg: DDPMUNetConfig = DDPMUNetConfig(),
                 run_cfg: DiffusionRunConfig = DiffusionRunConfig(),
                 params: Optional[Mapping[str, torch.Tensor]] = None,
                 seed: int = 0, bucket_min: int = 2, layout: str = "auto",
                 device=None):
        self._build(SIGEFusedUNet, model_cfg, run_cfg, params, seed,
                    bucket_min, layout, device)
        sched = DiffusionSchedule.create(
            run_cfg.beta_schedule, run_cfg.beta_start, run_cfg.beta_end,
            run_cfg.total_steps)
        if run_cfg.sampler_type == "ddim":
            self.sampler = DDIMSampler(sched, eta=run_cfg.eta)
        elif run_cfg.sampler_type == "ddpm":
            self.sampler = DDPMSampler(sched)
        elif run_cfg.sampler_type == "dpm_solver":
            self.sampler = DPMSolverSampler(
                sched, algorithm_type=run_cfg.algorithm_type,
                order=run_cfg.order, solver_type=run_cfg.solver_type,
                lower_order_final=run_cfg.lower_order_final)
        else:
            raise ValueError(f"sampler_type {run_cfg.sampler_type!r}")

    def _build(self, unet, model_cfg, run_cfg, params, seed, bucket_min,
               layout, device) -> None:
        """The device (resolved first: it raises without a GPU), the U-Net
        ``unet(model_cfg)`` in its engine, and its weights."""
        self.model_cfg = model_cfg
        self.run_cfg = run_cfg
        self.device = resolve_device(device)
        self.module = unet(model_cfg)
        self.model = SIGEModel(self.module, bucket_min=bucket_min,
                               layout=layout, device=self.device)
        if params is None:
            self.model.init(seed)
        else:
            self.module.load_state_dict(params)
        self.last_edit_ratio = None

    def _cond(self) -> torch.Tensor:
        """The model's second input for planning and profiling: t = 0."""
        return torch.zeros((1,), device=self.device)

    @property
    def active_layout(self) -> str:
        """The layout the last planned edit runs ("tiles" or "window")."""
        return self.model.active_layout

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    # ------------------------------------------------------------------
    def preprocess(self, original: np.ndarray, edited: np.ndarray
                   ) -> Tuple[torch.Tensor, torch.Tensor, np.ndarray]:
        """Difference mask -> dilation -> full-mode pre-run -> mask pyramid
        -> planning (reference: diffusion/runner.py:149-178).

        Inputs are [H, W, C] or [1, H, W, C] in [0, 1].
        Returns (x0 original [1,H,W,C], x0 edited [1,H,W,C]) on the device
        and the mask [H,W] (numpy).
        """
        cfg, rc = self.model_cfg, self.run_cfg
        R = cfg.resolution
        o = np.asarray(original, np.float32).reshape(1, R, R, -1)
        e = np.asarray(edited, np.float32).reshape(1, R, R, -1)
        o = data_transform(o[..., : cfg.in_ch], rc.rescaled)
        e = data_transform(e[..., : cfg.in_ch], rc.rescaled)
        mask = compute_difference_mask(o, e, eps=rc.eps)
        mask = dilate_mask(mask, rc.mask_dilate_radius)

        x0, x1 = self._tensor(o), self._tensor(e)
        self.model.full(x0, self._cond())  # records meta + fills caches
        min_res = R // (2 ** (len(cfg.ch_mult) - 1))
        self.model.set_masks(downsample_mask(mask, min_res=min_res))
        self.last_edit_ratio = float(np.mean(mask))
        return x0, x1, mask

    # ------------------------------------------------------------------
    def generate(self, original: np.ndarray, edited: np.ndarray,
                 seed: int = 0) -> np.ndarray:
        """SDEdit: noise both images to ``noise_level``, denoise with the
        twin full/sparse trajectory, return the edited result in [0, 1]
        ([H, W, C] numpy). The noise comes from a ``torch.Generator``
        seeded with ``seed`` on the runner's device. The layout the edit
        ran is :attr:`active_layout`."""
        rc = self.run_cfg
        x0, x1, mask = self.preprocess(original, edited)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        e = torch.randn(x0.shape, generator=gen, device=self.device)
        seq = get_sampling_sequence(rc.sample_steps, rc.noise_level,
                                    rc.skip_type)
        xts = self.sampler.q_sample(torch.cat([x0, x1]), int(seq[-1]),
                                    torch.cat([e, e]))
        out = self.sampler.sample_sige(self.model, xts, seq,
                                       self._tensor(mask), x0, e,
                                       generator=gen)
        return inverse_data_transform(out[-1].cpu().numpy(), rc.rescaled)

    # ------------------------------------------------------------------
    def count_macs(self, x: torch.Tensor, mode: str = "sparse") -> float:
        """Analytic MACs of one forward in ``mode`` (convs, attention
        products and linear layers, as ``sige_tpu``'s traced count)."""
        ctx = SIGECtx(mode=mode, macs=[])
        with torch.inference_mode(), fp32_scope():
            self.module(x, self._cond(), ctx=ctx)
        return float(sum(ctx.macs))

    def profile(self, original: np.ndarray, edited: np.ndarray,
                warmup: int = 20, iters: int = 100,
                mode: str = "sparse") -> Dict[str, float]:
        """Latency of a single forward on the edited input (median and
        90th percentile of ``iters`` forwards, each between two CUDA
        events, after ``warmup``), its analytic MACs and the peak device
        memory it allocates (the reference times the sparse forward alone;
        reference: diffusion/runner.py:214-246) beside the resident
        parameters, caches and plan (:func:`~.common.memory_entry`), and
        the layout it ran (``active_layout``). GPU only."""
        if self.device.type != "cuda":
            raise RuntimeError("profile measures the GPU; this runner is on "
                               f"{self.device}")
        x0, x1, mask = self.preprocess(original, edited)
        cond = self._cond()
        fwd = {"sparse": self.model.sparse, "dense": self.model.dense,
               "full": self.model.full}[mode]
        for _ in range(warmup):
            fwd(x1, cond)
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        for start, end in events:
            start.record()
            fwd(x1, cond)
            end.record()
        torch.cuda.synchronize(self.device)
        times = sorted(s.elapsed_time(e) for s, e in events)

        torch.cuda.reset_peak_memory_stats(self.device)
        fwd(x1, cond)
        torch.cuda.synchronize(self.device)
        peak_mb = torch.cuda.max_memory_allocated(self.device) / 2**20
        return {
            "latency_ms": float(np.median(times)),
            "latency_p90_ms": float(np.percentile(times, 90)),
            "iters": iters,
            "macs_g": self.count_macs(x1, mode) / 1e9,
            "edit_ratio": float(np.mean(mask)),
            "peak_mb": peak_mb,
            **memory_entry(self.model, mode),
            "active_layout": self.active_layout,
        }
