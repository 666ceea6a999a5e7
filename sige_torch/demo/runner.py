"""Interactive demo runner: one full trajectory of the base image, then
sparse-only edits over per-step cache slots — the port of
``sige_tpu.demo.runner``.

The reference demo's key trick (reference: diffusion_demo/runner.py,
samplers/ddim_ddpm_sampler.py:60-66): unlike the benchmark runners there
is NO per-step full pass. A single full sampling run of the *base* image
fills one cache slot per denoising step (``cache_id = step``), and each
edit then runs sparse-only steps reading its step's slot. "Apply" commits
an edit with ``sparse_update``, so the caches advance without a full
pass.

``sige_tpu`` fuses each trajectory into one ``lax.scan`` program; here
the steps are a Python loop over the engine's eager forwards, as in
:mod:`sige_torch.samplers.ddim_ddpm`. ``sige_tpu`` draws the base
image's noise from ``jax.random.key(seed)``, which torch cannot
reproduce: :meth:`DemoRunner.reset_base_image` takes the noise as an
argument and otherwise draws it from a seeded ``torch.Generator``.

:class:`MultiSessionDemoRunner` holds S users on one model, each with
their own base image, noise, slots and plan (an
:class:`~sige_torch.nn.engine.EngineState` per session, switched by
reference). ``sige_tpu``'s runner vmaps one program over every session
and discards the other rows; this one runs the requesting session alone,
which gives that session the same result.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.masks import compute_difference_mask, dilate_mask, downsample_mask
from ..models.ddpm import DDPMUNetConfig, SIGEFusedUNet
from ..nn.engine import EngineState, SIGEModel, resolve_device
from ..runners.diffusion_runner import data_transform, inverse_data_transform
from ..samplers import (DDIMSampler, DiffusionSchedule, DPMSolverSampler,
                        get_sampling_sequence)
from ..samplers.ddim_ddpm import _steps as ddim_steps

SAMPLERS = ("ddim", "dpm_solver")


@dataclasses.dataclass
class DemoSession:
    """One user's editing state: the engine's state (per-step cache slots
    and the edit's plan), the base image in [-1, 1] on the device, its
    host copy (for the difference mask) and its fixed noise."""

    state: EngineState
    base_x0: Optional[torch.Tensor] = None
    base_host: Optional[np.ndarray] = None
    base_e: Optional[torch.Tensor] = None

    def fork(self) -> "DemoSession":
        """A session that starts from this one's state, sharing every
        tensor by reference (see :meth:`EngineState.fork`)."""
        return dataclasses.replace(self, state=self.state.fork())


class DemoRunner:
    """The demo's runner (``sige_tpu.demo.runner.DemoRunner``'s
    defaults: 25 sample steps from noise level 400 of 1000, dilation
    radius 5, ``bucket_min`` 2, the tile layout). ``sampler_type``:
    "ddim" or "dpm_solver" (DPM-Solver++, the reference demo's default;
    reference: diffusion_demo/configs). ``params`` is a state dict for
    the U-Net; without one the weights are drawn from ``seed``.
    ``device=None`` means the GPU."""

    def __init__(self, model_cfg: Optional[DDPMUNetConfig] = None,
                 sample_steps: int = 25, noise_level: int = 400,
                 total_steps: int = 1000, mask_dilate_radius: int = 5,
                 params=None, seed: int = 0, bucket_min: int = 2,
                 sampler_type: str = "ddim", layout: str = "tiles",
                 device=None):
        if sampler_type not in SAMPLERS:
            raise ValueError(f"sampler_type {sampler_type!r} not in "
                             f"{SAMPLERS}")
        self.sampler_type = sampler_type
        self.mask_dilate_radius = mask_dilate_radius
        self.seq = [int(s) for s in get_sampling_sequence(sample_steps,
                                                          noise_level)]
        # one cache slot per denoising step
        self.model_cfg = dataclasses.replace(
            model_cfg or DDPMUNetConfig(), cache_slots=len(self.seq))
        self.device = resolve_device(device)
        self.module = SIGEFusedUNet(self.model_cfg)
        self.model = SIGEModel(self.module, bucket_min=bucket_min,
                               layout=layout, device=self.device)
        if params is None:
            self.model.init(seed)
        else:
            self.module.load_state_dict(params)
        schedule = DiffusionSchedule.create("linear", 1e-4, 2e-2, total_steps)
        self.sampler = (DPMSolverSampler(schedule)
                        if sampler_type == "dpm_solver"
                        else DDIMSampler(schedule))
        self.session = DemoSession(self.model.state)

    def use(self, session: DemoSession) -> None:
        """Run the following calls on ``session`` (by reference)."""
        self.session = session
        self.model.use(session.state)

    @property
    def base_x0(self) -> Optional[torch.Tensor]:
        return self.session.base_x0

    @property
    def base_e(self) -> Optional[torch.Tensor]:
        return self.session.base_e

    def _x0(self, image: np.ndarray) -> Tuple[np.ndarray, torch.Tensor]:
        R = self.model_cfg.resolution
        x = data_transform(np.asarray(image, np.float32).reshape(1, R, R, -1),
                           True)
        return x, torch.as_tensor(np.ascontiguousarray(x), device=self.device)

    def _out(self, x: torch.Tensor) -> np.ndarray:
        return inverse_data_transform(x[0].cpu().numpy(), True)

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def reset_base_image(self, image: np.ndarray, noise=None,
                         seed: int = 0) -> np.ndarray:
        """One full sampling run of the base image ([H, W, C] in [0, 1]),
        filling slot i with step i's caches (reference:
        diffusion_demo/ui/display_pad.py:48-55). ``noise`` ([1, H, W, C])
        is the trajectory's fixed noise (reference: runner.py:112); None
        draws it from a CPU ``torch.Generator`` seeded with ``seed``.
        Returns the base conversion result in [0, 1]."""
        host, x0 = self._x0(image)
        if noise is None:
            noise = torch.randn(x0.shape,
                                generator=torch.Generator().manual_seed(seed))
        e = torch.as_tensor(noise, dtype=torch.float32).reshape(
            x0.shape).to(self.device)
        xt = self.sampler.q_sample(x0, self.seq[-1], e)
        if self.sampler_type == "dpm_solver":
            out = self._dpm_trajectory(xt, "full")
        else:
            out = self._full_trajectory(xt)
        s = self.session
        s.base_x0, s.base_host, s.base_e = x0, host, e
        return self._out(out)

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def generate(self, edited: np.ndarray,
                 sparse_update: bool = False) -> np.ndarray:
        """Sparse-only conversion of an edited image against the per-step
        base caches (reference: diffusion_demo/runner.py:112-167);
        ``sparse_update`` ("apply") commits it into the caches and makes
        it the base image."""
        s = self.session
        if s.base_x0 is None:
            raise RuntimeError("call reset_base_image first")
        host, x1 = self._x0(edited)
        mask = compute_difference_mask(s.base_host, host, eps=1e-2)
        if not mask.any():  # skip if mask empty (reference: runner.py:126)
            return self._out(s.base_x0)
        mask = dilate_mask(mask, self.mask_dilate_radius)
        cfg = self.model_cfg  # the pyramid down to the bottleneck
        min_res = cfg.resolution // (2 ** (len(cfg.ch_mult) - 1))
        self.model.set_masks(downsample_mask(mask, min_res=min_res))
        xt = self.sampler.q_sample(x1, self.seq[-1], s.base_e)
        m = torch.as_tensor(mask, device=self.device)
        if self.sampler_type == "dpm_solver":
            out = self._dpm_trajectory(xt, "sparse", m, sparse_update)
        else:
            out = self._sparse_trajectory(xt, m, sparse_update)
        if sparse_update:
            s.base_x0, s.base_host = x1, host
        return self._out(out)

    # ------------------------------------------------------------------
    def _ddim(self, x, et, t: int, t_next: int):
        sched = self.sampler.schedule
        return self.sampler.update(x, et, sched.alpha(t), sched.alpha(t_next),
                                   t, 0.0)

    def _t(self, t: int) -> torch.Tensor:
        return torch.full((1,), float(t), device=self.device)

    def _full_trajectory(self, xt):
        """Full-mode DDIM trajectory: slot i <- step i's caches and
        affines (``sige_tpu``'s ``_full_trajectory``)."""
        x = xt
        for slot, (t, t_next) in enumerate(ddim_steps(self.seq)):
            et = self.model.full(x, self._t(t), cache_id=slot)
            x = self._ddim(x, et, t, t_next)
        return x

    def _sparse_trajectory(self, xt, mask, sparse_update: bool):
        """Sparse-only DDIM trajectory over the per-step slots, blended
        back to the base trajectory outside the mask at each step's
        ``t_next`` (``sige_tpu``'s ``_sparse_trajectory``)."""
        s = self.session
        x = xt
        for slot, (t, t_next) in enumerate(ddim_steps(self.seq)):
            et = self.model.sparse(x, self._t(t), cache_id=slot,
                                   sparse_update=sparse_update)
            x = self._ddim(x, et, t, t_next)
            x = self.sampler._post_process(x, t_next, mask, s.base_x0,
                                           s.base_e)
        return x

    def _dpm_trajectory(self, xt, mode: str, mask=None,
                        sparse_update: bool = False):
        """Multistep DPM-Solver++ trajectory with per-step cache slots
        (``sige_tpu``'s ``_dpm_demo_trajectory``): model evaluation i
        reads and writes slot i, and a sparse trajectory blends back to
        the base trajectory outside ``mask`` after each update."""
        model, s = self.model, self.session

        def model_step(x, t_int: int, slot: int):
            t = self._t(t_int)
            if mode == "full":
                et = model.full(x, t, cache_id=slot)
            else:
                et = model.sparse(x, t, cache_id=slot,
                                  sparse_update=sparse_update)
            return self.sampler.data_prediction(x, et, t_int)

        return self.sampler.trajectory(model_step, xt, self.seq,
                                       mask if mode == "sparse" else None,
                                       s.base_x0, s.base_e)


class MultiSessionDemoRunner:
    """S concurrent editing sessions on one model, each with its OWN base
    image, noise, per-step cache slots and edit plan (the reference demo
    serves one user per process; diffusion_demo/start.py).

    The first reset seeds every session: a session not yet reset starts
    from that state, sharing its tensors by reference (``sige_tpu``
    tiles the first reset over the session axis). ``generate(i)`` runs
    session i alone; ``sparse_update`` commits session i alone."""

    def __init__(self, num_sessions: int, model_cfg=None, **kwargs):
        self.inner = DemoRunner(model_cfg, **kwargs)
        self.S = int(num_sessions)
        self.sessions: List[Optional[DemoSession]] = [None] * self.S

    def _check(self, i: int) -> None:
        if not 0 <= i < self.S:
            raise IndexError(f"session {i} outside 0..{self.S - 1}")

    def reset_base_image(self, i: int, image: np.ndarray, noise=None,
                         seed: int = 0) -> np.ndarray:
        """Full sampling run of session ``i``'s base image into its own
        slots (arguments as :meth:`DemoRunner.reset_base_image`)."""
        self._check(i)
        first = self.sessions[0] is None
        if not first:
            self.inner.use(self.sessions[i])
        out = self.inner.reset_base_image(image, noise=noise, seed=seed)
        if first:
            seed_session = self.inner.session
            self.sessions = [seed_session if j == i else seed_session.fork()
                             for j in range(self.S)]
        return out

    def generate(self, i: int, edited: np.ndarray,
                 sparse_update: bool = False) -> np.ndarray:
        """Sparse-only conversion of session ``i``'s edit; no other
        session runs or changes."""
        self._check(i)
        if self.sessions[i] is None:
            raise RuntimeError("call reset_base_image first")
        self.inner.use(self.sessions[i])
        return self.inner.generate(edited, sparse_update=sparse_update)
