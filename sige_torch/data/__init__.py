"""Datasets and image IO for the benchmark suites (PNG through the port's
own codec; no PIL)."""

from .datasets import CityscapesEditDataset, SDEditDataset
from .image import load_image, resize_bicubic, save_image

__all__ = ["SDEditDataset", "CityscapesEditDataset", "load_image",
           "resize_bicubic", "save_image"]
