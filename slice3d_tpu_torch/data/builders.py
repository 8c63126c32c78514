"""Single-image ingestion: one RGBA picture as a dataset the CLIs read.

The JAX package's ``slice3d_tpu/data/builders.py::create_single_image_dataset``
(reference create_dataset_sin_img.py:22-81) without Pillow: the picture
becomes view 004 of object ``00000`` (its alpha bounding box moved to the
middle by ``data/image.py::center_rgba``, which rounds as Pillow's masked
paste), with an identity ``meta.pkl``, 12 blank RGBA slices of
``img_size``, a zero SDF array and one-id split lists.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from .dataset import SLICE_ORDER
from .image import center_rgba, encode_png, load_image

__all__ = ["create_single_image_dataset"]


def _save_meta(path: str, azimuths, elevations, distances, scale, offset) -> None:
    k = np.zeros((3, 3))
    cam_poses = np.zeros((len(azimuths), 3, 4))
    with open(path, "wb") as f:
        pickle.dump([k, np.asarray(azimuths), np.asarray(elevations), np.asarray(distances),
                     cam_poses, scale, np.asarray(offset)], f)


def _write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def create_single_image_dataset(img_path: str, root: str, *, img_size: int = 256,
                                center_obj: bool = True) -> str:
    """Write ``root``'s dataset layout from one RGBA image; returns ``root``."""
    uid = "00000"
    for d in ("00_img_input", "01_img_slices", "02_sdfs", "03_splits"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    img = load_image(img_path)
    if img.ndim != 3 or img.shape[-1] != 4:
        raise ValueError("input image must be RGBA (alpha marks the object)")
    if center_obj:
        img = center_rgba(img)
    view_dir = os.path.join(root, "00_img_input", uid)
    os.makedirs(view_dir, exist_ok=True)
    _write_png(os.path.join(view_dir, "004.png"), img)
    _save_meta(os.path.join(view_dir, "meta.pkl"), np.zeros(12), np.zeros(12),
               np.ones(12) * 1.2, 1.0, np.zeros(3))
    sdir = os.path.join(root, "01_img_slices", uid, "004")
    os.makedirs(sdir, exist_ok=True)
    blank = np.zeros((img_size, img_size, 4), np.uint8)
    for axis, part in SLICE_ORDER:
        _write_png(os.path.join(sdir, f"{axis}_{part}.png"), blank)
    np.save(os.path.join(root, "02_sdfs", f"{uid}.npy"), np.zeros((16384, 4)))
    for split in ("train", "val", "test"):
        with open(os.path.join(root, "03_splits", f"{split}.lst"), "w") as f:
            f.write(uid)
    return root
