"""LDM slice dataset: the 12 slice images and the input view of each sample.

The JAX package's ``slice3d_tpu/data/ldm_data.py`` (reference
gen_slices/ldm/data/objaverse.py:9-115 and custom_sin_img.py:9-105), read
with the port's Pillow-free image IO: each sample stacks the 12 slices
(order X1-4, Z4-1, Y1-4) and the input view, each white-background
composited, resized to ``size`` (Pillow's bilinear) and scaled to [-1, 1],
as a (13, H, W, 3) array.

Splits (reference objaverse.py:57-62): ``train`` takes a random view per
fetch, ``validation`` / ``test`` view 4, ``trainval_rec`` walks the trainval
list once per view (index ``i`` -> shape ``i % n_shapes``, view
``i // n_shapes``), for dumping VAE reconstructions.
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from .dataset import SLICE_ORDER, preprocess_image
from .image import load_image

__all__ = ["LDMSliceDataset"]

_SPLIT_LST = {"train": "train.lst", "validation": "val.lst", "val": "val.lst",
              "test": "test.lst", "trainval_rec": "trainval.lst"}
_SLICES_DIR = {"gt": "01_img_slices", "gen": "04_img_slices_gen", "gt_rec": "05_img_slices_rec"}


@dataclass
class LDMSliceDataset:
    root: str
    split: str = "train"
    size: int = 128
    n_views: int = 12
    from_which_slices: str = "gt"  # gt | gt_rec | gen

    def __post_init__(self):
        with open(os.path.join(self.root, "03_splits", _SPLIT_LST[self.split])) as f:
            self.image_ids: List[str] = f.read().split()
        self.n_shapes = len(self.image_ids)
        self.dir_img_slices = os.path.join(self.root, _SLICES_DIR[self.from_which_slices])
        self.dir_img_input = os.path.join(self.root, "00_img_input")

    def __len__(self) -> int:
        if self.split == "trainval_rec":
            return self.n_shapes * self.n_views
        return self.n_shapes

    def _view_for(self, index: int, rng: Optional[random.Random]) -> int:
        if self.split == "train":
            return (rng or random).randint(0, self.n_views - 1)
        if self.split == "trainval_rec":
            return index // self.n_shapes
        return 4  # the fixed evaluation view (reference objaverse.py:60)

    def __getitem__(self, index: int, rng: Optional[random.Random] = None
                    ) -> Dict[str, np.ndarray]:
        shape_id = self.image_ids[index % self.n_shapes]
        view = self._view_for(index, rng)
        vname = "%03d" % view
        vdir = os.path.join(self.dir_img_slices, shape_id, vname)
        imgs = [preprocess_image(load_image(os.path.join(vdir, f"{axis}_{part}.png")),
                                 self.size, white_bg=True) for axis, part in SLICE_ORDER]
        img_ipt = preprocess_image(
            load_image(os.path.join(self.dir_img_input, shape_id, f"{vname}.png")),
            self.size, white_bg=True)
        imgs.append(img_ipt)
        return {"image": np.stack(imgs).astype(np.float32),  # (13, H, W, 3)
                "img_ipt_view": img_ipt.astype(np.float32), "view": np.int32(view)}
