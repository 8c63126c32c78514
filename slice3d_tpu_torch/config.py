"""The port's option registry: the JAX package's ``Options`` copied field for
field, so the CLIs of both packages take the same command lines.

``Options``, ``get_parser`` and ``options_from_args`` are the JAX package's
(``slice3d_tpu/config.py``), which mirror the reference flag surface.
``require_ported`` raises for the options whose machinery the port does not
have yet, so none is silently ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass

__all__ = ["Options", "get_parser", "options_from_args", "require_ported"]


@dataclass
class Options:
    # model
    name_model: str = "slicenet"  # slicenet | disn | gtslice
    # dataset
    dir_data: str = "./data"
    name_dataset: str = "objaverse"
    n_wk: int = 8
    categories_train: str = "objaverse,"
    categories_test: str = "objaverse,"
    img_size: int = 128
    n_qry: int = 256
    n_slices: int = 12
    n_views: int = 12
    pred_type: str = "sdf"  # occ | sdf
    use_white_bg: bool = False
    # experiment
    name_exp: str = "default_exp"
    name_exp_cam: str = "cam_exp"
    mode: str = "train"  # train | val | test
    n_bs: int = 16
    n_epochs: int = 600
    lr: float = 3e-4
    n_dim: int = 128
    multi_gpu: bool = False  # more than one device: not ported (require_ported)
    freq_ckpt: int = 4
    freq_log: int = 200
    freq_decay: int = 100
    # NOTE: despite the (reference-inherited) name, this is the LR decay
    # FACTOR applied every freq_decay epochs (reference train.py:179-181),
    # not an AdamW weight decay.  Prefer `lr_decay_factor` in new code.
    weight_decay: float = 0.5
    resume: bool = False
    est_campose: bool = False
    back_bone_cam_est: str = "vgg16_bn"
    # marching-cube operating point
    mc_chunk_size: int = 32768
    mc_res0: int = 64
    mc_up_steps: int = 2
    mc_threshold: float = 0.5
    simplify_nfaces: int = 0  # 0 = no simplification
    mc_refine_steps: int = 0  # refine_mesh RMSprop iterations (0 = off)
    mc_batch_size: int = 1  # objects per device dispatch at reconstruction
    # sharding at reconstruction in the JAX package: batch | points (the
    # port runs on one device; only the default is accepted)
    mc_shard_axis: str = "batch"
    mc_extract: str = "surface_nets"  # isosurfacer: surface_nets | tetrahedra
    # testing
    name_ckpt: str = ""
    name_ckpt_cam: str = ""
    from_which_slices: str = "gt"  # gt | gt_rec | gen
    overwrite_res: bool = False
    dtype: str = "bfloat16"  # inference compute dtype: bfloat16 | float32
    # training compute dtype (mixed precision: params/optimizer moments and
    # the loss stay float32; only layer compute runs bf16).  float32 default
    # reproduces the reference's torch numerics exactly.
    train_dtype: str = "float32"
    # composite/resize/normalize on the device (not ported)
    device_preprocess: bool = False
    # the JAX package's training-checkpoint format (read by neither CLI here)
    ckpt_backend: str = "msgpack"
    vgg19_ckpt: str = ""  # torch vgg19 weights for the perceptual loss
    random_init: bool = False  # run with random weights (benchmarks/smoke)
    dir_experiments: str = "experiments"

    @property
    def lr_decay_factor(self) -> float:
        """Clear alias for the confusingly-named ``weight_decay`` flag."""
        return self.weight_decay

    @property
    def dataset_root(self) -> str:
        return os.path.join(self.dir_data, self.name_dataset)

    @property
    def exp_dir(self) -> str:
        return os.path.join(self.dir_experiments, self.name_exp)

    @property
    def categories(self):
        if self.name_dataset == "shapenet":
            key = self.categories_train if self.mode == "train" else self.categories_test
            return [c for c in key.split(",") if c]
        return [""]


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    for f in dataclasses.fields(Options):
        flag = f"--{f.name}"
        if f.type == "bool" or isinstance(f.default, bool):
            parser.add_argument(flag, action=argparse.BooleanOptionalAction,
                                default=f.default)
        else:
            parser.add_argument(flag, type=type(f.default), default=f.default)
    return parser


def options_from_args(args=None) -> Options:
    ns = get_parser().parse_args(args)
    return Options(**{f.name: getattr(ns, f.name) for f in dataclasses.fields(Options)})


# option -> (its default, what is missing, where the work is queued)
_UNPORTED = {
    "mc_shard_axis": ("batch", "sharding the query points over devices",
                      "ROADMAP Queue 1 item 12"),
    "multi_gpu": (False, "more than one device", "ROADMAP Queue 1 item 12"),
    "device_preprocess": (False, "on-device image preprocessing", "ROADMAP Queue 1 item 8"),
}


def require_ported(opts: Options) -> None:
    """Raise for an option the port cannot honour yet: any option of
    ``_UNPORTED`` set to anything but its default."""
    for name, (default, what, where) in _UNPORTED.items():
        value = getattr(opts, name)
        if value != default:
            raise NotImplementedError(f"--{name} {value}: {what} is not ported yet ({where})")
