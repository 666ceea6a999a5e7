"""AlexNet feature backbone + LPIPS heads — the port of
``sige_tpu.metrics.backbones.alexnet``.

The reference computes LPIPS with the ``lpips`` package's AlexNet in
spatial mode (reference: diffusion/metrics/lpips_score.py:26). Weights
come from local files: the torchvision ``alexnet`` state dict for the
backbone and the lpips ``alex.pth`` lin heads. The module keeps
torchvision's ``features`` numbering, so its state dict is the
checkpoint's ``features.*`` entries.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

from .common import nchw, place, run, seeded_state

# lpips's input scaling layer constants (public; lpips/networks_basic.py)
LPIPS_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
LPIPS_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

#: indices of the ReLUs whose outputs LPIPS taps, in ``features``
TAPS = (1, 4, 7, 9, 11)
CHANNELS = (64, 192, 384, 256, 256)


class AlexNetFeatures(nn.Module):
    """torchvision AlexNet ``features`` trunk (conv 11x11 stride 4 pad 2,
    max-pools 3/2 without padding); returns the five ReLU tap activations
    LPIPS uses (channels 64/192/384/256/256), NCHW."""

    def __init__(self):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2d(3, 64, 11, stride=4, padding=2), nn.ReLU(),
            nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, padding=2), nn.ReLU(),
            nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2d(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2d(256, 256, 3, padding=1), nn.ReLU(),
        )

    def forward(self, x) -> List[torch.Tensor]:
        taps = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in TAPS:
                taps.append(x)
        return taps


def convert_alexnet(sd: Mapping) -> Dict[str, torch.Tensor]:
    """torchvision ``alexnet`` state dict -> :class:`AlexNetFeatures`'
    state dict (the ``features.{0,3,6,8,10}`` convs; ``classifier.*``
    dropped)."""
    return {f"features.{i}.{leaf}": torch.as_tensor(
                np.asarray(sd[f"features.{i}.{leaf}"], np.float32))
            for i in (0, 3, 6, 8, 10) for leaf in ("weight", "bias")}


def convert_lpips_lins(sd: Mapping) -> List[np.ndarray]:
    """lpips ``alex.pth`` -> per-layer [C] channel weights
    (keys lin{i}.model.1.weight, shape [1, C, 1, 1])."""
    return [np.asarray(sd[f"lin{i}.model.1.weight"]).reshape(-1)
            for i in range(5)]


class LPIPSAlex:
    """images in [-1, 1] NHWC -> LPIPS features/distance
    (plugs into :func:`sige_torch.metrics.lpips.lpips_from_features`).
    Without ``alexnet_sd`` the backbone is untrained (seeded); without
    ``lpips_sd`` every lin is uniform, 1 / C. ``device``: None means the
    GPU (raises without one)."""

    def __init__(self, alexnet_sd: Optional[Mapping],
                 lpips_sd: Optional[Mapping], device=None):
        module = AlexNetFeatures()
        state = (seeded_state(module) if alexnet_sd is None
                 else convert_alexnet(alexnet_sd))
        self.module = place(module, state, device)
        if lpips_sd is None:
            self.lins = [np.ones((c,), np.float32) / c for c in CHANNELS]
        else:
            self.lins = convert_lpips_lins(lpips_sd)

    def features(self, img: np.ndarray) -> List[np.ndarray]:
        """The five taps of one image [H, W, 3] (or [1, H, W, 3]) as
        [H_l, W_l, C_l] host arrays."""
        x = (np.asarray(img, np.float32) - LPIPS_SHIFT) / LPIPS_SCALE
        if x.ndim == 3:
            x = x[None]
        taps = run(self.module, nchw(x, self.module))
        return [t[0].permute(1, 2, 0).cpu().numpy() for t in taps]

    def __call__(self, a: np.ndarray, b: np.ndarray, mask=None) -> float:
        from ..lpips import lpips_from_features

        return lpips_from_features(self.features(a), self.features(b),
                                   self.lins, mask=mask)
