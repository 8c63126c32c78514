"""Train the camera-pose estimator of ``reconstruct --est_campose`` on the card
(root ``train_cam.py``).

    python -m slice3d_tpu_torch.train_cam --name_exp_cam cam1 --name_dataset objaverse \
        [--device cpu]

Takes the root CLI's flags plus ``--device`` (default ``cuda``).  With
``SLICE3D_COORDINATOR`` / ``SLICE3D_NUM_PROCESSES`` / ``SLICE3D_PROCESS_ID``
set, each process joins one data-parallel group (``parallel.init_distributed``;
``--multi_gpu`` is accepted, the sharding is automatic); the
checkpoints land in ``<dir_experiments>/<name_exp_cam>/ckpt``.
"""

from __future__ import annotations

import argparse

from .config import options_from_args
from .parallel import init_distributed
from .train.train_cam import CamTrainer


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    own, rest = parser.parse_known_args(argv)
    opts = options_from_args(rest)
    init_distributed(device=own.device)
    CamTrainer(lr=opts.lr, img_size=opts.img_size, device=own.device).train(opts)


if __name__ == "__main__":
    main()
