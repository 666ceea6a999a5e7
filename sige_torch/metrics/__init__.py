"""Quality metrics: PSNR, LPIPS, FID, mIoU — the port of
``sige_tpu.metrics``.

Mirrors the reference's metric harnesses (reference: diffusion/metrics/,
gaugan/metrics/). PSNR, mIoU and the FID statistics are float64 numpy on
the host; the LPIPS, FID and mIoU backbones (AlexNet, InceptionV3,
DRN-D-105; :mod:`.backbones`) run on the card, with weights from
user-supplied local files.
"""

from .fid import compute_fid, frechet_distance, gaussian_stats
from .lpips import LPIPS, lpips_from_features
from .miou import CITYSCAPES_ID_TO_TRAIN_ID, confusion_matrix, mean_iou, to_train_ids
from .psnr import psnr

__all__ = [
    "psnr",
    "LPIPS",
    "lpips_from_features",
    "gaussian_stats",
    "frechet_distance",
    "compute_fid",
    "confusion_matrix",
    "mean_iou",
    "CITYSCAPES_ID_TO_TRAIN_ID",
    "to_train_ids",
]
