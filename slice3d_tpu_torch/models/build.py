"""Model factory and weight loading for the port's CLIs.

``build_model`` mirrors ``slice3d_tpu/models/build.py::build_model`` for the
inference models: bf16 with the fused encoder route, or fp32 with the plain
route (both kernel routes take bf16 only).  ``load_model`` gives the model
its weights: the port's seeded init for ``--random_init`` or no checkpoint,
else a reference torch checkpoint, whose ``state_dict`` names the port uses
as they are.
"""

from __future__ import annotations

import os
import zipfile
from typing import Optional, Union

import torch

from ..config import Options
from .gtslice import GTSliceModel, init_gtslice
from .slicenet import SliceNetModel, init_slicenet

__all__ = ["build_model", "load_model"]

Model = Union[SliceNetModel, GTSliceModel]


def _dtype_route(opts: Options):
    if opts.dtype == "bfloat16":
        return torch.bfloat16, "fused"
    if opts.dtype == "float32":
        return None, "plain"
    raise ValueError(f"unknown --dtype {opts.dtype!r}: bfloat16 or float32")


def _check_model(opts: Options) -> None:
    if opts.name_model not in ("slicenet", "gtslice"):
        raise ValueError(f"unknown or unported model {opts.name_model!r}: slicenet or "
                         "gtslice (disn is ROADMAP Queue 1 item 7)")


def build_model(opts: Options) -> Model:
    """An inference SliceNet or GTSlice with ``opts``' slice count and
    compute dtype, its parameters left as the constructor made them."""
    _check_model(opts)
    dtype, route = _dtype_route(opts)
    cls = SliceNetModel if opts.name_model == "slicenet" else GTSliceModel
    return cls(opts.n_slices, route=route, dtype=dtype).eval()


def _is_torch_file(path: str) -> bool:
    """torch.save's zip format (or its legacy pickle)."""
    if zipfile.is_zipfile(path):
        return True
    with open(path, "rb") as f:
        return f.read(2) in (b"\x80\x02", b"\x80\x04")


def load_model(opts: Options, ckpt_path: Optional[str] = None) -> Model:
    """The model of ``opts`` with its weights.

    * ``--random_init`` or no checkpoint: the port's seeded init (seed 0);
    * a reference torch checkpoint (a ``state_dict``, or a dict holding one
      under ``"model"``): loaded strictly;
    * the JAX package's msgpack or orbax checkpoints: a ``ValueError``, since
      the port reads torch checkpoints only.
    """
    _check_model(opts)
    if ckpt_path is None or opts.random_init:
        dtype, route = _dtype_route(opts)
        init = init_slicenet if opts.name_model == "slicenet" else init_gtslice
        return init(0, n_slices=opts.n_slices, route=route, dtype=dtype).eval()
    if os.path.isdir(ckpt_path) or not _is_torch_file(ckpt_path):
        raise ValueError(f"{ckpt_path} is not a torch checkpoint (the JAX package's msgpack "
                         "and orbax checkpoints are not read by the port): convert it to a "
                         "reference state_dict first")
    payload = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    state = payload.get("model", payload) if isinstance(payload, dict) else payload
    model = build_model(opts)
    model.load_state_dict(state)
    return model
