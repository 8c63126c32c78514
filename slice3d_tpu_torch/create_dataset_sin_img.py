"""Build a single-image dataset (the root ``create_dataset_sin_img.py``).

    python -m slice3d_tpu_torch.create_dataset_sin_img --img_path ./input.png \\
        --name_dataset custom_sin_img

A host tool (no model): writes ``<dir_data>/<name_dataset>`` through
``data/builders.py::create_single_image_dataset``.
"""

from __future__ import annotations

import argparse
import os

from .data.builders import create_single_image_dataset

__all__ = ["main"]


def main(argv=None) -> str:
    parser = argparse.ArgumentParser()
    parser.add_argument("--img_path", type=str, default="./imgs/demo/input.png")
    parser.add_argument("--name_dataset", type=str, default="custom_sin_img")
    parser.add_argument("--dir_data", type=str, default="./data")
    parser.add_argument("--img_size", type=int, default=256)
    # type=bool as the root CLI has it: any non-empty value is true
    parser.add_argument("--center_obj", type=bool, default=True)
    args = parser.parse_args(argv)
    root = create_single_image_dataset(
        args.img_path, os.path.join(args.dir_data, args.name_dataset),
        img_size=args.img_size, center_obj=args.center_obj)
    print(f"dataset written to {root}")
    return root


if __name__ == "__main__":
    main()
