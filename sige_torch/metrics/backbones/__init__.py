"""Metric feature backbones (PyTorch, on the card) + torch-state-dict
converters — the port of ``sige_tpu.metrics.backbones``.

Weights come from local copies of the public checkpoints (torchvision
alexnet/inception_v3, lpips alex.pth, drn-d-105_ms_cityscapes.pth); the
modules keep those checkpoints' names, so each converter only drops or
strips what the module has no use for."""

from .alexnet import AlexNetFeatures, LPIPSAlex, convert_alexnet, convert_lpips_lins
from .drn import CityscapesSegmenter, DRNSeg, convert_drn_seg
from .inception import FIDInception, InceptionV3Features, convert_inception_v3

__all__ = [
    "AlexNetFeatures", "LPIPSAlex", "convert_alexnet", "convert_lpips_lins",
    "InceptionV3Features", "FIDInception", "convert_inception_v3",
    "DRNSeg", "CityscapesSegmenter", "convert_drn_seg",
]
