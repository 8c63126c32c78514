"""Dump SliceNet's predicted slices as PNGs (the root ``reconstruct_slices.py``).

    python -m slice3d_tpu_torch.reconstruct_slices --name_dataset objaverse \\
        --name_exp my_exp --name_ckpt model.ckpt [--device cpu --dtype float32]

Takes the root CLI's flags (``config.Options``; the model is always
SliceNet) plus ``--device`` (default ``cuda``), and writes
``experiments/<exp>/results_slices/<dataset>/<id>/{X,Z,Y}_{1..4}.png``: each
of the 12 slices of the test split's view, scaled to uint8 and resized to
256 x 256 with Pillow's bilinear filter (``data/image.py::resize_bilinear``).
The checkpoint may be a reference torch file or a JAX msgpack one.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .config import options_from_args
from .data.dataset import SLICE_ORDER, Slice3DDataset
from .data.image import encode_png, resize_bilinear
from .models.build import load_model
from .parallel import device_count, reconstruction_mesh
from .pipeline import Reconstructor

__all__ = ["main"]


def main(argv=None) -> str:
    """Run the CLI; returns the directory written to."""
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    own, rest = parser.parse_known_args(argv)
    opts = options_from_args(rest)
    opts.name_model = "slicenet"
    ckpt_path = os.path.join(opts.exp_dir, "ckpt", opts.name_ckpt) if opts.name_ckpt else None
    mesh = reconstruction_mesh(opts.mc_shard_axis, 1, opts.mc_chunk_size,
                               device_count(own.device))
    recon = Reconstructor(load_model(opts, ckpt_path), chunk_size=opts.mc_chunk_size,
                          device=own.device, mesh=mesh, shard_axis=opts.mc_shard_axis)
    dataset = Slice3DDataset(opts.dataset_root, split="test", img_size=opts.img_size,
                             n_views=opts.n_views, use_white_bg=opts.use_white_bg,
                             load_slices=False, load_sdf=False, categories=opts.categories)
    out_root = os.path.join(opts.exp_dir, "results_slices", opts.name_dataset)
    for idx in range(len(dataset)):
        _, shape_id = dataset.files[idx]
        slices = recon.predicted_slices(dataset[idx]["img_input"])  # (S, H, W, 3)
        out_dir = os.path.join(out_root, shape_id)
        os.makedirs(out_dir, exist_ok=True)
        for s, (axis, part) in enumerate(SLICE_ORDER):
            img = ((slices[s] + 1.0) * 127.5).clip(0, 255).astype(np.uint8)
            with open(os.path.join(out_dir, f"{axis}_{part}.png"), "wb") as f:
                f.write(encode_png(resize_bilinear(img, (256, 256))))
        print(f"[{idx + 1}/{len(dataset)}] wrote slices for {shape_id}")
    return out_root


if __name__ == "__main__":
    main()
