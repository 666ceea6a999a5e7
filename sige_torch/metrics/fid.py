"""FID: Frechet distance between Gaussian fits of feature distributions —
the port of ``sige_tpu.metrics.fid`` (reference:
diffusion/metrics/fid_score.py wraps clean-fid). The statistics are
float64 numpy on the host; the feature extractor is pluggable (any
callable images -> [N, D] features), by default the port's InceptionV3 on
the card."""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np


def gaussian_stats(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) of an [N, D] feature matrix."""
    features = np.asarray(features, np.float64)
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, sigma


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    """Matrix square root of a (near-)PSD symmetric matrix via eigh
    (negative eigenvalues clipped to 0)."""
    vals, vecs = np.linalg.eigh((mat + mat.T) / 2.0)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """d^2 = |mu1 - mu2|^2 + Tr(s1 + s2 - 2 sqrt(s1 s2))."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    sigma1 = np.asarray(sigma1, np.float64)
    sigma2 = np.asarray(sigma2, np.float64)
    diff = mu1 - mu2
    # sqrt(s1 s2) computed via the symmetric form sqrt(sqrt(s1) s2 sqrt(s1))
    s1_half = _sqrtm_psd(sigma1 + eps * np.eye(sigma1.shape[0]))
    covmean = _sqrtm_psd(s1_half @ sigma2 @ s1_half)
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * np.trace(covmean))


def compute_fid(
    images_a: np.ndarray,
    images_b: np.ndarray,
    feature_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    batch_size: int = 32,
) -> float:
    """FID between two image sets using ``feature_fn`` (default: the
    port's untrained InceptionV3 on the card)."""
    if feature_fn is None:
        feature_fn = make_inception_feature_fn()

    def feats(images):
        out = []
        for i in range(0, len(images), batch_size):
            out.append(np.asarray(feature_fn(images[i : i + batch_size])))
        return np.concatenate(out, axis=0)

    mu1, s1 = gaussian_stats(feats(images_a))
    mu2, s2 = gaussian_stats(feats(images_b))
    return frechet_distance(mu1, s1, mu2, s2)


def make_inception_feature_fn(weights_path: Optional[str] = None,
                              device=None):
    """InceptionV3 pool features through
    :class:`sige_torch.metrics.backbones.FIDInception`, from a locally
    stored torchvision ``inception_v3`` state dict at ``weights_path``.
    Without one the backbone is UNTRAINED (seeded): the FID number is
    meaningless, but the whole pipeline (features -> Gaussian statistics
    -> Frechet distance) runs — the dry-run mode of ``cli.get_metric``.
    ``device``: None means the GPU (raises without one)."""
    from .backbones import FIDInception

    if weights_path is None:
        return FIDInception(None, device=device)
    from ..utils.convert import load_torch_state_dict

    return FIDInception(load_torch_state_dict(weights_path), device=device)
