"""Train SliceNet on the card (root ``train.py``; reference reg_slices/train.py).

    python -m slice3d_tpu_torch.train --name_exp exp1 --name_dataset objaverse \
        --name_model slicenet [--vgg19_ckpt vgg19.pth] [--device cpu]

Takes the root CLI's flags plus ``--device`` (default ``cuda``).  With
``SLICE3D_COORDINATOR`` / ``SLICE3D_NUM_PROCESSES`` / ``SLICE3D_PROCESS_ID``
set, each process joins one data-parallel group (``parallel.init_distributed``;
``--multi_gpu`` is accepted, the sharding is automatic); GTSlice
trains through ``python -m slice3d_tpu_torch.train_gt``.
"""

from __future__ import annotations

import argparse

from ..config import options_from_args
from ..parallel import init_distributed
from .train_reg import train


def main(argv=None):
    """Run the CLI; returns the final training state."""
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    own, rest = parser.parse_known_args(argv)
    opts = options_from_args(rest)
    init_distributed(device=own.device)
    if opts.name_model == "gtslice":
        raise SystemExit("use slice3d_tpu_torch.train_gt for the gtslice model")
    return train(opts, device=own.device)


if __name__ == "__main__":
    main()
