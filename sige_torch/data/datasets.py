"""Benchmark datasets — the port of ``sige_tpu.data.datasets``.

* :class:`SDEditDataset` — LSUN-church SDEdit pairs: ``original/`` and
  ``edited/`` PNG directories with matching names
  (reference: diffusion/datasets/sdedit_dataset.py).
* :class:`CityscapesEditDataset` — cityscapes-edit: a ``meta.csv`` pairing
  ground-truth and synthetic label/instance ``.npy`` maps, with symmetric
  editing (each pair used in both directions) doubling the set
  (reference: gaugan/cityscapes_dataset.py:26-41).
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional

import numpy as np

from .image import load_image


class SDEditDataset:
    def __init__(self, root: str, image_metas: Optional[List[str]] = None):
        self.root = root
        orig_dir = os.path.join(root, "original")
        names = sorted(
            os.path.splitext(f)[0]
            for f in os.listdir(orig_dir)
            if f.endswith(".png")
        )
        if image_metas:
            names = [n for n in names if n in set(image_metas)]
        self.names = names

    def __len__(self):
        return len(self.names)

    def __getitem__(self, i: int) -> Dict:
        name = self.names[i]
        original = load_image(os.path.join(self.root, "original", name + ".png"))
        edited = load_image(os.path.join(self.root, "edited", name + ".png"))
        return {"name": name, "original": original, "edited": edited}


class CityscapesEditDataset:
    def __init__(self, root: str, symmetric: bool = True,
                 image_ids: Optional[List[int]] = None):
        self.root = root
        rows = []
        with open(os.path.join(root, "meta.csv")) as f:
            for row in csv.DictReader(f):
                rows.append(row)
        if image_ids is not None:
            keep = set(int(i) for i in image_ids)
            rows = [r for r in rows if int(r.get("id", -1)) in keep]
        self.items = []
        for r in rows:
            self.items.append((r, False))
            if symmetric:
                self.items.append((r, True))  # gt<->synthetic swapped

    def __len__(self):
        return len(self.items)

    def _load(self, rel: str) -> np.ndarray:
        return np.load(os.path.join(self.root, rel))

    def __getitem__(self, i: int) -> Dict:
        row, swapped = self.items[i]
        gt_l, gt_i = self._load(row["gt_label"]), self._load(row["gt_instance"])
        sy_l, sy_i = self._load(row["synthetic_label"]), self._load(row["synthetic_instance"])
        if swapped:
            gt_l, sy_l = sy_l, gt_l
            gt_i, sy_i = sy_i, gt_i
        return {
            "name": f"{row.get('id', i)}{'-sym' if swapped else ''}",
            "original_label": gt_l,
            "original_instance": gt_i,
            "edited_label": sy_l,
            "edited_instance": sy_i,
        }
