"""GauGAN runner: semantic-map editing with SPADE generators — the port of
``sige_tpu.runners.gaugan_runner``.

Reference flow (reference: gaugan/runner.py:79-195): assemble one-hot
label + instance-edge semantics, compute the difference mask between the
original and edited semantics (eps 1e-3), run full mode on the original,
build the mask pyramid down to the latent (sh, sw), then run sparse mode
on the edited semantics. One shot: no denoising loop. ``profile`` times
one forward with CUDA events and counts its analytic MACs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..core.masks import compute_difference_mask, dilate_mask, downsample_mask
from ..models.gaugan import SIGEFusedSPADEGenerator, SPADEGenConfig
from ..nn.engine import SIGEModel, fp32_scope, resolve_device
from ..nn.module import SIGECtx
from .common import memory_entry


@dataclasses.dataclass(frozen=True)
class GauGANRunConfig:
    input_nc: int = 35                 # label classes (one-hot)
    use_instance: bool = True
    mask_eps: float = 1e-3
    mask_dilate_radius: int = 1
    downsample_dilate_radius: int = 2


def get_edges(instance: np.ndarray) -> np.ndarray:
    """Instance boundary map [H, W] float (reference: gaugan/runner.py:79-85)."""
    t = np.asarray(instance)
    edge = np.zeros(t.shape, bool)
    edge[:, 1:] |= t[:, 1:] != t[:, :-1]
    edge[:, :-1] |= t[:, 1:] != t[:, :-1]
    edge[1:, :] |= t[1:, :] != t[:-1, :]
    edge[:-1, :] |= t[1:, :] != t[:-1, :]
    return edge.astype(np.float32)


class GauGANRunner:
    """Drives a SPADE generator through one semantic edit.

    ``params`` is a state dict for the generator (e.g. from
    :func:`sige_torch.utils.from_jax.state_dict_from_flax`); without one
    the weights are drawn from ``seed`` (BatchNorm running statistics at 0
    and 1, as flax initializes them). ``module`` replaces the fused
    generator (e.g. the sub-mobile one). ``device=None`` means the GPU and
    raises when there is none. ``layout="auto"`` (the default, as in
    ``sige_tpu``) picks the window or tile layout per edit;
    ``active_layout`` says which the last edit ran."""

    def __init__(self, model_cfg: SPADEGenConfig = SPADEGenConfig(),
                 run_cfg: GauGANRunConfig = GauGANRunConfig(),
                 params: Optional[Mapping[str, torch.Tensor]] = None,
                 seed: int = 0, bucket_min: int = 2, module=None,
                 layout: str = "auto", device=None):
        self.model_cfg = model_cfg
        self.run_cfg = run_cfg
        self.device = resolve_device(device)
        self.module = module or SIGEFusedSPADEGenerator(model_cfg)
        # the fused generator's window chains cross the bare 2x upsamples,
        # which needs the planner's cross-resolution nesting
        nesting = (model_cfg.window_chain
                   and isinstance(self.module, SIGEFusedSPADEGenerator))
        self.model = SIGEModel(self.module, bucket_min=bucket_min,
                               layout=layout, chain_nesting=nesting,
                               device=self.device)
        if params is None:
            self.model.init(seed)
        else:
            self.module.load_state_dict(params)
        self.last_edit_ratio = None

    @property
    def active_layout(self) -> str:
        """The layout the last planned edit runs ("tiles" or "window")."""
        return self.model.active_layout

    def preprocess_input(self, label: np.ndarray,
                         instance: Optional[np.ndarray] = None) -> np.ndarray:
        """[H, W] integer label (+instance) maps -> [1, H, W, semantic_nc]
        one-hot + edge semantics (reference: gaugan/runner.py:87-106)."""
        rc = self.run_cfg
        label = np.asarray(label, np.int64)
        H, W = label.shape
        onehot = np.zeros((H, W, rc.input_nc), np.float32)
        np.put_along_axis(onehot, label[:, :, None], 1.0, axis=2)
        chans = [onehot]
        if rc.use_instance:
            chans.append(get_edges(label if instance is None
                                   else instance)[:, :, None])
        return np.concatenate(chans, axis=-1)[None]

    def preprocess(self, original_sem: np.ndarray, edited_sem: np.ndarray
                   ) -> Tuple[torch.Tensor, torch.Tensor, np.ndarray]:
        """Plan sparse inference from a pair of semantics maps
        [1, H, W, semantic_nc]: the difference mask, the full pass on the
        original, the mask pyramid, the plan. Returns (original, edited)
        on the device and the mask [H, W] (numpy)."""
        rc = self.run_cfg
        mask = compute_difference_mask(original_sem[0], edited_sem[0],
                                       eps=rc.mask_eps)
        mask = dilate_mask(mask, rc.mask_dilate_radius)
        x0, x1 = (torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                  device=self.device)
                  for a in (original_sem, edited_sem))
        self.model.full(x0)
        self.model.set_masks(downsample_mask(
            mask, min_res=self.model_cfg.latent_hw,
            dilation=rc.downsample_dilate_radius))
        self.last_edit_ratio = float(np.mean(mask))
        return x0, x1, mask

    def generate(self, original_sem: np.ndarray, edited_sem: np.ndarray
                 ) -> np.ndarray:
        """The generated edited image [H, W, 3] in [-1, 1] (numpy)."""
        _, x1, _ = self.preprocess(original_sem, edited_sem)
        return self.model.sparse(x1)[0].cpu().numpy()

    def count_macs(self, x: torch.Tensor, mode: str = "sparse") -> float:
        """Analytic MACs of one forward in ``mode`` (the convs; as
        ``sige_tpu``'s traced count)."""
        ctx = SIGECtx(mode=mode, macs=[])
        with torch.inference_mode(), fp32_scope():
            self.module(x, ctx=ctx)
        return float(sum(ctx.macs))

    def profile(self, original_sem: np.ndarray, edited_sem: np.ndarray,
                warmup: int = 20, iters: int = 100,
                mode: str = "sparse") -> Dict[str, float]:
        """Latency of one forward on the edited semantics (median and 90th
        percentile of ``iters`` forwards, each between two CUDA events,
        after ``warmup``), its analytic MACs, the peak device memory it
        allocates beside the resident parameters, caches and plan
        (:func:`~.common.memory_entry`), and the layout it ran. GPU
        only."""
        if self.device.type != "cuda":
            raise RuntimeError("profile measures the GPU; this runner is on "
                               f"{self.device}")
        _, x1, mask = self.preprocess(original_sem, edited_sem)
        fwd = {"sparse": self.model.sparse, "dense": self.model.dense,
               "full": self.model.full}[mode]
        for _ in range(warmup):
            fwd(x1)
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        for start, end in events:
            start.record()
            fwd(x1)
            end.record()
        torch.cuda.synchronize(self.device)
        times = sorted(s.elapsed_time(e) for s, e in events)

        torch.cuda.reset_peak_memory_stats(self.device)
        fwd(x1)
        torch.cuda.synchronize(self.device)
        return {
            "latency_ms": float(np.median(times)),
            "latency_p90_ms": float(np.percentile(times, 90)),
            "iters": iters,
            "macs_g": self.count_macs(x1, mode) / 1e9,
            "edit_ratio": float(np.mean(mask)),
            "peak_mb": torch.cuda.max_memory_allocated(self.device) / 2**20,
            **memory_entry(self.model, mode),
            "active_layout": self.active_layout,
        }
