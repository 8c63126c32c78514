"""Model factory and weight loading for the port's CLIs.

``build_model`` mirrors ``slice3d_tpu/models/build.py::build_model`` for the
inference models: bf16 (SliceNet and GTSlice on the fused encoder route), or
fp32 (the plain route; both kernel routes take bf16 only).  ``load_model``
gives the model its weights: the port's seeded init for ``--random_init`` or
no checkpoint, else a reference torch checkpoint, whose ``state_dict`` names
the port uses as they are, or a msgpack checkpoint of the JAX package
(``train_reg.py`` / ``train_cam.py`` payloads, or bare variables), read by
``train/flax_msgpack.py`` and mapped by ``convert.py``.  ``load_camnet``
does the same for the camera pose estimator of ``--est_campose``, from
``--name_exp_cam`` / ``--name_ckpt_cam``.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

from .. import convert
from ..config import Options
from ..train.checkpoint import is_torch_file
from ..train.flax_msgpack import ORBAX_MESSAGE, read_flax_msgpack
from .camnet import CameraNet, init_camnet
from .disn import DISNModel, init_disn
from .gtslice import GTSliceModel, init_gtslice
from .slicenet import SliceNetModel, init_slicenet

__all__ = ["build_model", "load_model", "load_camnet"]

Model = Union[SliceNetModel, GTSliceModel, DISNModel]
MODELS = ("slicenet", "gtslice", "disn")
# flax variables -> state_dict, by model (CameraNet for --est_campose)
_CONVERTERS = {"slicenet": convert.slicenet_state_dict, "gtslice": convert.gtslice_state_dict,
               "disn": convert.disn_state_dict, "camnet": convert.camnet_state_dict}


def _dtype_route(opts: Options):
    if opts.dtype == "bfloat16":
        return torch.bfloat16, "fused"
    if opts.dtype == "float32":
        return None, "plain"
    raise ValueError(f"unknown --dtype {opts.dtype!r}: bfloat16 or float32")


def _check_model(opts: Options) -> None:
    if opts.name_model not in MODELS:
        raise ValueError(f"unknown model {opts.name_model!r}: one of {MODELS}")


def build_model(opts: Options) -> Model:
    """An inference SliceNet, GTSlice or DISN with ``opts``' slice count
    (DISN: image size) and compute dtype, its parameters left as the
    constructor made them."""
    _check_model(opts)
    dtype, route = _dtype_route(opts)
    if opts.name_model == "disn":
        return DISNModel(img_size=opts.img_size, dtype=dtype).eval()
    cls = SliceNetModel if opts.name_model == "slicenet" else GTSliceModel
    return cls(opts.n_slices, route=route, dtype=dtype).eval()


def _state_dict(ckpt_path: str, name: str):
    """The ``state_dict`` of model ``name`` in a checkpoint: a reference torch
    file's (the file's, or the one it holds under ``"model"``), or a JAX
    msgpack file's variables (under ``"variables"``, or the whole tree)
    mapped to the reference names.  Orbax directories raise a ``ValueError``
    that names their conversion to msgpack."""
    if os.path.isdir(ckpt_path):
        raise ValueError(ORBAX_MESSAGE.format(path=ckpt_path))
    if is_torch_file(ckpt_path):
        payload = torch.load(ckpt_path, map_location="cpu", weights_only=True)
        return payload.get("model", payload) if isinstance(payload, dict) else payload
    tree = read_flax_msgpack(ckpt_path)
    return _CONVERTERS[name](tree["variables"] if "variables" in tree else tree)


def load_model(opts: Options, ckpt_path: Optional[str] = None) -> Model:
    """The model of ``opts`` with its weights.

    * ``--random_init`` or no checkpoint: the port's seeded init (seed 0);
    * a reference torch checkpoint (a ``state_dict``, or a dict holding one
      under ``"model"``), or a JAX msgpack checkpoint: loaded strictly;
    * a JAX orbax checkpoint (a directory): a ``ValueError`` naming the
      conversion to msgpack.
    """
    _check_model(opts)
    if ckpt_path is None or opts.random_init:
        dtype, route = _dtype_route(opts)
        if opts.name_model == "disn":
            return init_disn(0, img_size=opts.img_size, dtype=dtype).eval()
        init = init_slicenet if opts.name_model == "slicenet" else init_gtslice
        return init(0, n_slices=opts.n_slices, route=route, dtype=dtype).eval()
    state = _state_dict(ckpt_path, opts.name_model)
    model = build_model(opts)
    model.load_state_dict(state)
    return model


def load_camnet(opts: Options) -> CameraNet:
    """The fp32 CameraNet of ``--est_campose``: the checkpoint (reference torch
    or JAX msgpack) at ``<dir_experiments>/<name_exp_cam>/ckpt/<name_ckpt_cam>``
    when that file exists, else the seeded init (seed 0) with a note, as the
    JAX CLI does."""
    path = (os.path.join(opts.dir_experiments, opts.name_exp_cam, "ckpt", opts.name_ckpt_cam)
            if opts.name_ckpt_cam else None)
    if path and os.path.exists(path):
        model = CameraNet(opts.img_size)
        model.load_state_dict(_state_dict(path, "camnet"))
        return model.eval()
    print("est_campose: no camera checkpoint found, using random weights")
    return init_camnet(0, img_size=opts.img_size)
