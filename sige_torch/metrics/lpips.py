"""LPIPS perceptual distance — the port of ``sige_tpu.metrics.lpips``
(reference: diffusion/metrics/lpips_score.py wraps the ``lpips`` package
in spatial mode with an optional mask restriction).

The metric: unit-normalize backbone features at several layers, take
channel-weighted squared differences, average spatially, and sum layers.
The AlexNet backbone runs on the card; the learned per-channel weights
and the distance are host numpy. Weights come from local files.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def normalize_tensor(feat: np.ndarray, eps: float = 1e-10) -> np.ndarray:
    """Unit-normalize along the channel axis (last)."""
    norm = np.sqrt((feat**2).sum(axis=-1, keepdims=True))
    return feat / (norm + eps)


def lpips_from_features(
    feats_a: Sequence[np.ndarray],
    feats_b: Sequence[np.ndarray],
    lin_weights: Sequence[np.ndarray],
    mask: Optional[np.ndarray] = None,
) -> float:
    """LPIPS given per-layer features [H_l, W_l, C_l] and per-channel
    linear weights [C_l]. With ``mask`` ([H, W] bool at image resolution),
    each layer's spatial map is averaged over the (resized) masked region
    only — the reference's spatial-mode mask restriction."""
    total = 0.0
    for fa, fb, w in zip(feats_a, feats_b, lin_weights):
        da = normalize_tensor(fa) - normalize_tensor(fb)
        dist = (da**2 * np.asarray(w)).sum(axis=-1)  # [H_l, W_l]
        if mask is not None:
            m = _resize_mask(np.asarray(mask, np.float32), dist.shape)
            denom = m.sum()
            total += float((dist * m).sum() / max(denom, 1e-8))
        else:
            total += float(dist.mean())
    return total


def _resize_mask(mask: np.ndarray, hw) -> np.ndarray:
    """Nearest resize by integer index (row ``i`` of ``oh`` reads source
    row ``i * H // oh``)."""
    H, W = mask.shape
    oh, ow = hw
    rows = (np.arange(oh) * H) // oh
    cols = (np.arange(ow) * W) // ow
    return mask[rows][:, cols]


class LPIPS:
    """LPIPS with the port's AlexNet backbone
    (:class:`sige_torch.metrics.backbones.LPIPSAlex`); the reference uses
    ``lpips.LPIPS(net="alex", spatial=True)``
    (reference: diffusion/metrics/lpips_score.py:26).

    ``backbone_path``: torchvision ``alexnet`` state dict (.pth).
    ``lin_path``: the lpips package's ``alex.pth`` lin heads. Both are
    local files; without the first the backbone is untrained (seeded),
    without the second the lins are uniform. ``device``: None means the
    GPU (raises without one).
    """

    def __init__(self, backbone_path: Optional[str] = None,
                 lin_path: Optional[str] = None, net: str = "alex",
                 device=None):
        if net != "alex":
            raise NotImplementedError("only the alex backbone is wired")
        from ..utils.convert import load_torch_state_dict
        from .backbones import LPIPSAlex

        alex_sd = load_torch_state_dict(backbone_path) if backbone_path else None
        lin_sd = load_torch_state_dict(lin_path) if lin_path else None
        self._impl = LPIPSAlex(alex_sd, lin_sd, device=device)

    def __call__(self, a: np.ndarray, b: np.ndarray,
                 mask: Optional[np.ndarray] = None) -> float:
        """a, b: [H, W, 3] in [0, 1] (scaled to [-1, 1] internally, the
        lpips convention)."""
        return self._impl(np.asarray(a) * 2.0 - 1.0,
                          np.asarray(b) * 2.0 - 1.0, mask=mask)
