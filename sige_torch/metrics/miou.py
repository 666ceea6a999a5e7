"""mIoU over Cityscapes trainIds — the port of ``sige_tpu.metrics.miou``
(reference: gaugan/metrics/miou_score.py + get_trainIds.py; the reference
segments generated images with a pretrained DRN-D-105, which is
:class:`sige_torch.metrics.backbones.CityscapesSegmenter` here)."""

from __future__ import annotations

from typing import Optional

import numpy as np

#: Standard Cityscapes labelId -> trainId mapping (19 eval classes;
#: 255 = ignore). From the public cityscapesScripts label definitions.
CITYSCAPES_ID_TO_TRAIN_ID = np.array(
    [255, 255, 255, 255, 255, 255, 255,  # 0-6: void/ego/rect border...
     0,    # 7 road
     1,    # 8 sidewalk
     255, 255,
     2,    # 11 building
     3,    # 12 wall
     4,    # 13 fence
     255, 255, 255,
     5,    # 17 pole
     255,
     6,    # 19 traffic light
     7,    # 20 traffic sign
     8,    # 21 vegetation
     9,    # 22 terrain
     10,   # 23 sky
     11,   # 24 person
     12,   # 25 rider
     13,   # 26 car
     14,   # 27 truck
     15,   # 28 bus
     255, 255,
     16,   # 31 train
     17,   # 32 motorcycle
     18,   # 33 bicycle
     255,  # 34 (license plate / unlabeled tail)
     ], dtype=np.int64)


def to_train_ids(label_map: np.ndarray) -> np.ndarray:
    """Map raw Cityscapes label ids to the 19 trainIds (255 = ignore)."""
    label_map = np.asarray(label_map, np.int64)
    return CITYSCAPES_ID_TO_TRAIN_ID[np.clip(label_map, 0, 34)]


def confusion_matrix(pred: np.ndarray, gt: np.ndarray, num_classes: int = 19,
                     mask: Optional[np.ndarray] = None) -> np.ndarray:
    """[C, C] confusion over valid (gt < num_classes) pixels, optionally
    restricted to a spatial mask (the reference's edited-region mIoU)."""
    pred = np.asarray(pred, np.int64).reshape(-1)
    gt = np.asarray(gt, np.int64).reshape(-1)
    valid = gt < num_classes
    if mask is not None:
        valid &= np.asarray(mask, bool).reshape(-1)
    pred, gt = pred[valid], gt[valid]
    idx = gt * num_classes + np.clip(pred, 0, num_classes - 1)
    return np.bincount(idx, minlength=num_classes**2).reshape(
        num_classes, num_classes)


def mean_iou(conf: np.ndarray) -> float:
    """mIoU over classes that appear (union > 0)."""
    conf = np.asarray(conf, np.float64)
    inter = np.diag(conf)
    union = conf.sum(0) + conf.sum(1) - inter
    present = union > 0
    if not present.any():
        return float("nan")
    return float((inter[present] / union[present]).mean())
