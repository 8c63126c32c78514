"""Train GTSlice, the GT-slices-to-3D model, on the card (root ``train_gt.py``;
reference reg_slices/train_gt.py).

    python -m slice3d_tpu_torch.train_gt --name_exp exp_gt --name_dataset objaverse \
        --from_which_slices gt_rec [--device cpu]

Takes the root CLI's flags plus ``--device`` (default ``cuda``).
"""

from __future__ import annotations

import argparse

from .config import options_from_args
from .train.train_reg import train


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    own, rest = parser.parse_known_args(argv)
    opts = options_from_args(rest)
    opts.name_model = "gtslice"
    train(opts, device=own.device)


if __name__ == "__main__":
    main()
