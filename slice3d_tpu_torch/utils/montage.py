"""Slice montage IO: the on-disk interchange format of the generation path.

The JAX package's ``slice3d_tpu/utils/montage.py``, with the port's PNG
encoder in place of Pillow.  A montage is a (4H, 4W, 3) image: rows are the
slice groups [0-3, 4-7, 8-11, zero pad], columns the 4 parts, as the
reference's test_step grid (gen_slices ddpm.py:368-397) lays them out and
``re_org_slices`` reads them.
"""

from __future__ import annotations

import numpy as np

from ..data.image import encode_png

__all__ = ["slices_to_montage", "montage_to_slices", "save_image", "to_uint8"]


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[-1, 1] float -> uint8 (truncating, as the JAX package does)."""
    return ((np.clip(img, -1.0, 1.0) + 1.0) * 127.5).astype(np.uint8)


def slices_to_montage(slices: np.ndarray) -> np.ndarray:
    """(12, H, W, 3) -> (4H, 4W, 3) montage with the zero pad row."""
    s, h, w, c = slices.shape
    if s != 12:
        raise ValueError("montage expects 12 slices")
    rows = [np.concatenate(list(slices[r * 4:(r + 1) * 4]), axis=1) for r in range(3)]
    rows.append(np.zeros_like(rows[0]))
    return np.concatenate(rows, axis=0)


def montage_to_slices(montage: np.ndarray, img_size: int) -> np.ndarray:
    """(>= 3 img_size, 4 img_size, C) -> (12, img_size, img_size, C)."""
    return np.stack([montage[r * img_size:(r + 1) * img_size,
                             c * img_size:(c + 1) * img_size]
                     for r in range(3) for c in range(4)])


def save_image(img: np.ndarray, path: str) -> None:
    """uint8 (H, W[, C]) -> a PNG file."""
    with open(path, "wb") as f:
        f.write(encode_png(img))
