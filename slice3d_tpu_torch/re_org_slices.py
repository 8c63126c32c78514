"""Crop sampled slice montages back into the dataset layout.

    python -m slice3d_tpu_torch.re_org_slices --dir_slices <logdir>/images_testing_sampled \\
        --type_slices gen --name_dataset objaverse --dir_data ./data --n_bs 8

The root ``re_org_slices.py`` (reference gen_slices/re_org_slices.py) with
the port's PNG codec: montage ``{batch}_{case}.png`` (``batch, case =
divmod(i, n_bs)`` over the split's ids) becomes ``04_img_slices_gen/<id>/004/``
(``gen``, the test split) or ``05_img_slices_rec/<id>/<view>/`` (``rec``, the
trainval split once per view, tiles already there kept), one tile per slice
in the dataset's order: X_1..4, Z_4..1, Y_1..4.  ``--n_bs`` must be the
sampling config's batch size.  A host tool: it runs no model.
"""

from __future__ import annotations

import argparse
import os

from .data.dataset import SLICE_ORDER
from .data.image import encode_png, load_image

__all__ = ["get_parser", "crop_slices", "main"]


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--dir_slices", type=str, required=True)
    p.add_argument("--type_slices", type=str, default="gen", choices=["gen", "rec"])
    p.add_argument("--name_dataset", type=str, default="objaverse")
    p.add_argument("--dir_data", type=str, default="./data")
    p.add_argument("--img_size", type=int, default=128)
    p.add_argument("--n_bs", type=int, default=8)
    p.add_argument("--n_views", type=int, default=12)
    return p


def crop_slices(args) -> int:
    """Crop every montage that exists; returns the number of tiles written."""
    root = os.path.join(args.dir_data, args.name_dataset)
    gen = args.type_slices == "gen"
    if gen:
        dir_tgt = os.path.join(root, "04_img_slices_gen")
        with open(os.path.join(root, "03_splits", "test.lst")) as f:
            uids = f.read().split()
    else:
        dir_tgt = os.path.join(root, "05_img_slices_rec")
        with open(os.path.join(root, "03_splits", "trainval.lst")) as f:
            uids = f.read().split() * args.n_views
    n_base = len(uids) if gen else len(uids) // args.n_views
    size = args.img_size
    written = 0
    for idx, uid in enumerate(uids):
        batch_id, case_id = divmod(idx, args.n_bs)
        view = "004" if gen else "%03d" % (idx // n_base)
        src = os.path.join(args.dir_slices, f"{batch_id}_{case_id}.png")
        if not os.path.exists(src):
            continue
        img = load_image(src)
        out_dir = os.path.join(dir_tgt, uid, view)
        os.makedirs(out_dir, exist_ok=True)
        # the montage's row-major grid is the dataset's SLICE_ORDER
        for s, (axis, part) in enumerate(SLICE_ORDER):
            r, c = divmod(s, 4)
            dst = os.path.join(out_dir, f"{axis}_{part}.png")
            if not gen and os.path.exists(dst):
                continue
            with open(dst, "wb") as f:
                f.write(encode_png(img[r * size:(r + 1) * size, c * size:(c + 1) * size]))
            written += 1
        if idx % 1000 == 0:
            print(idx)
    return written


def main(argv=None) -> int:
    return crop_slices(get_parser().parse_args(argv))


if __name__ == "__main__":
    main()
