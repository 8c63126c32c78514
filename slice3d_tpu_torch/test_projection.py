"""Projection self-check on the port's reader (the root ``test_projection.py``;
reference reg_slices/test_projection.py).

    python -m slice3d_tpu_torch.test_projection --dir_data ./data \\
        --name_dataset objaverse --shape_idx 0 --out proj_check.png

Projects the ``--n_pts`` GT SDF samples nearest the surface through the
camera chain (``obj_rot_mat``, then ``trans_mat_wo_rot_tp``, then the divide
by w, times ``--img_size``) onto the input view and writes it as a PNG with
a red 5 x 5 outline (corners open, a small circle) around the pixel that
holds each point, the pixels that the root script's Pillow ellipse draws: a
visual check that the camera math matches the renderer.  The flags are the
root script's.  It runs on the host: numpy and ``data/image.py``'s PNG
writer, no Pillow.
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np

from .data.dataset import Slice3DDataset
from .data.image import encode_png

__all__ = ["project_surface_points", "draw_outlines", "main"]

RED = np.array([255, 0, 0], np.uint8)
# the 5 x 5 outline's offsets, corners left open
_RING = [(dx, dy) for dx in range(-2, 3) for dy in range(-2, 3)
         if max(abs(dx), abs(dy)) == 2 and abs(dx) + abs(dy) < 4]


def project_surface_points(sample: Dict[str, np.ndarray], n_pts: int,
                           img_size: int) -> np.ndarray:
    """The ``n_pts`` query points of ``sample`` with the smallest |sdf| ->
    their (n, 2) pixel coordinates (x, y) on the input view."""
    band = np.argsort(np.abs(sample["sdf"]))[:n_pts]
    pts = sample["qry_norot"][band] @ sample["obj_rot_mat"]
    homo = np.concatenate([pts, np.ones((len(pts), 1), np.float32)], axis=1)
    uvw = homo @ sample["trans_mat_wo_rot_tp"]
    return uvw[:, :2] / uvw[:, 2:3] * img_size


def draw_outlines(img: np.ndarray, px: np.ndarray) -> np.ndarray:
    """A copy of the uint8 (H, W, 3) image with the red outline around the
    pixel that holds each (x, y) coordinate (parts off the image dropped)."""
    out = img.copy()
    h, w = out.shape[:2]
    centres = np.floor(px).astype(np.int64)
    for dx, dy in _RING:
        x, y = centres[:, 0] + dx, centres[:, 1] + dy
        keep = (x >= 0) & (x < w) & (y >= 0) & (y < h)
        out[y[keep], x[keep]] = RED
    return out


def main(argv=None) -> str:
    """Run the CLI; returns the PNG's path."""
    p = argparse.ArgumentParser()
    p.add_argument("--dir_data", type=str, default="./data")
    p.add_argument("--name_dataset", type=str, default="objaverse")
    p.add_argument("--img_size", type=int, default=256)
    p.add_argument("--shape_idx", type=int, default=0)
    p.add_argument("--split", type=str, default="test")
    p.add_argument("--n_pts", type=int, default=300)
    p.add_argument("--out", type=str, default="proj_check.png")
    args = p.parse_args(argv)

    ds = Slice3DDataset(f"{args.dir_data}/{args.name_dataset}", split=args.split,
                        img_size=args.img_size, n_qry=8192)
    sample = ds[args.shape_idx]
    img = ((sample["img_input"] + 1) * 127.5).astype(np.uint8)
    px = project_surface_points(sample, args.n_pts, args.img_size)
    with open(args.out, "wb") as f:
        f.write(encode_png(draw_outlines(img, px)))
    print(f"wrote {args.out} with {len(px)} projected surface points")
    return args.out


if __name__ == "__main__":
    main()
