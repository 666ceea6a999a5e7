"""The port's metric math (``sige_torch.metrics``) against ``sige_tpu``'s
on seeded numpy inputs: PSNR (plain, masked, ``inf`` on equal images),
the Cityscapes trainId map, the confusion matrix (ignore label, mask)
and mIoU, LPIPS's channel normalization and feature distance (with
masks at every layer size), the Gaussian statistics and the Frechet
distance. The float64 paths agree exactly or to 1e-12."""

import numpy as np
import pytest

from sige_torch import metrics as tm
from sige_torch.metrics import fid as tfid
from sige_torch.metrics import lpips as tlp
from sige_tpu import metrics as jm
from sige_tpu.metrics import fid as jfid
from sige_tpu.metrics import lpips as jlp


def test_psnr_matches(rng):
    a = rng.integers(0, 256, (24, 40, 3)).astype(np.float64)
    b = np.clip(a + rng.normal(0, 6, a.shape), 0, 255)
    mask = rng.random((24, 40)) < 0.3
    for m in (None, mask):
        assert tm.psnr(a, b, mask=m) == jm.psnr(a, b, mask=m)
    assert tm.psnr(a, a) == float("inf") == jm.psnr(a, a)
    b2 = a.copy()
    b2[12:] += 10
    top = np.zeros((24, 40), bool)
    top[:12] = True
    assert tm.psnr(a, b2, mask=top) == float("inf")
    with pytest.raises(ValueError, match="shape mismatch"):
        tm.psnr(a, a[:, :-1])


def test_miou_math_matches(rng):
    assert np.array_equal(tm.CITYSCAPES_ID_TO_TRAIN_ID,
                          jm.CITYSCAPES_ID_TO_TRAIN_ID)
    raw = rng.integers(-3, 40, (32, 48))
    assert np.array_equal(tm.to_train_ids(raw), jm.to_train_ids(raw))
    gt = jm.to_train_ids(rng.integers(0, 34, (32, 48)))
    pred = rng.integers(0, 21, (32, 48))  # beyond 18: clipped to the last
    mask = rng.random((32, 48)) < 0.5
    for m in (None, mask):
        ours = tm.confusion_matrix(pred, gt, mask=m)
        assert np.array_equal(ours, jm.confusion_matrix(pred, gt, mask=m))
        assert tm.mean_iou(ours) == jm.mean_iou(ours)
    assert tm.mean_iou(tm.confusion_matrix(gt, gt)) == 1.0
    assert np.isnan(tm.mean_iou(np.zeros((19, 19))))


def test_lpips_math_matches(rng):
    feats_a = [rng.standard_normal((h, h, c)).astype(np.float32)
               for h, c in ((15, 4), (7, 6), (3, 8))]
    feats_b = [f + rng.standard_normal(f.shape).astype(np.float32)
               for f in feats_a]
    w = [np.abs(rng.standard_normal(f.shape[-1])).astype(np.float32)
         for f in feats_a]
    for f in feats_a:
        assert np.array_equal(tlp.normalize_tensor(f), jlp.normalize_tensor(f))
    mask = np.zeros((64, 64), bool)
    mask[5:30, 20:50] = True
    for m in (None, mask):
        assert (tm.lpips_from_features(feats_a, feats_b, w, mask=m)
                == jm.lpips_from_features(feats_a, feats_b, w, mask=m))
    for hw in ((15, 15), (7, 11), (1, 1)):
        assert np.array_equal(tlp._resize_mask(mask, hw),
                              jlp._resize_mask(mask, hw))
    assert tm.lpips_from_features(feats_a, feats_a, w) == 0.0


def test_fid_statistics_match(rng):
    f1 = rng.standard_normal((60, 12)).astype(np.float32)
    f2 = (rng.standard_normal((60, 12)) * 1.3 + 0.5).astype(np.float32)
    (mu1, s1), (mu2, s2) = tm.gaussian_stats(f1), tm.gaussian_stats(f2)
    for ours, theirs in zip((mu1, s1, mu2, s2),
                            (*jm.gaussian_stats(f1), *jm.gaussian_stats(f2))):
        assert np.array_equal(ours, theirs)
    d = tm.frechet_distance(mu1, s1, mu2, s2)
    assert d == pytest.approx(jm.frechet_distance(mu1, s1, mu2, s2),
                              rel=1e-12, abs=1e-12)
    assert np.array_equal(tfid._sqrtm_psd(s1), jfid._sqrtm_psd(s1))
    assert tm.frechet_distance(mu1, s1, mu1, s1) < 1e-8
    # few samples, many features: singular covariances, as in a small FID
    g1, g2 = rng.standard_normal((5, 40)), rng.standard_normal((5, 40))
    args = (*tm.gaussian_stats(g1), *tm.gaussian_stats(g2))
    assert tm.frechet_distance(*args) == pytest.approx(
        jm.frechet_distance(*args), rel=1e-12)


def test_compute_fid_with_a_feature_fn(rng):
    """``compute_fid``'s batching over a plugged-in feature function."""
    a = rng.random((37, 4, 4, 3))
    b = rng.random((37, 4, 4, 3)) ** 2

    def feats(x):
        return np.asarray(x).reshape(len(x), -1)[:, :10]

    assert tm.compute_fid(a, b, feats, batch_size=8) == jm.compute_fid(
        a, b, feats, batch_size=32)
