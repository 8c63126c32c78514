"""Placing batches on a mesh, and what data-parallel training averages over
the process group (the JAX package's ``slice3d_tpu/parallel/sharding.py``).

``shard_batch`` / ``replicate`` are the placements of the JAX package's
``batch_sharding`` / ``replicate``: a tensor's leading axis split over the
mesh's data devices, or the whole tensor on each of them.  ``put_batch``
applies JAX's rule to a batch dict.  Under jit over a sharded batch the JAX
trainers' gradients, logs and BatchNorm statistics are those of the global
batch; here each process computes its local batch's, and
``all_reduce_gradients`` / ``all_reduce_mean`` average them over the group
(``models/layers.py::BatchNorm2d`` reduces its statistics itself).  The
collectives run whenever a group is joined, a group of one included, and
are no-ops without one.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Iterable, List, Mapping

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, in_group, rank, world_size

__all__ = ["shard_batch", "replicate", "put_batch", "rank_part", "all_reduce_average",
           "all_reduce_gradients", "all_reduce_mean", "all_reduce_sum", "broadcast_object",
           "barrier"]


def shard_batch(x: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """x's leading axis split into contiguous parts of ceil(rows / data
    devices) rows, part d on the mesh's data device d (where the axis does
    not divide, the last parts are shorter or empty)."""
    devs = mesh.data_devices
    per = -(-x.shape[0] // len(devs))
    return [x[d * per:(d + 1) * per].to(dev) for d, dev in enumerate(devs)]


def replicate(x: Any, mesh: Mesh) -> List[Any]:
    """A tensor (or a module) on each of the mesh's data devices: one copy a
    distinct device, shared where a device repeats.  A module is deep-copied
    for every device but the one it is on."""
    copies: Dict[torch.device, Any] = {}
    out = []
    for d in mesh.data_devices:
        if d not in copies:
            if isinstance(x, torch.nn.Module):
                on = next(x.parameters()).device
                copies[d] = x if on == d else copy.deepcopy(x).to(d)
            else:
                copies[d] = x.to(d)
        out.append(copies[d])
    return out


def put_batch(batch: Mapping[str, Any], mesh: Mesh) -> List[Dict[str, torch.Tensor]]:
    """A batch dict placed on the mesh: one dict per data device.

    Each process passes its local portion (the global batch is the process
    count x the local one, every process reading its own shard); a leaf
    whose batch axis divides by the data axis is split over the devices, any
    other leaf (a small eval batch, an odd remainder, a scalar) is
    replicated and must then be the same on every process.  The port's
    trainers hold one card a process, where this is the batch itself, and
    call it not; it serves a caller that spreads one process's batch over
    several devices, as the JAX trainers do."""
    devs = mesh.data_devices
    out: List[Dict[str, torch.Tensor]] = [{} for _ in devs]
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
        parts = (shard_batch(t, mesh) if t.dim() > 0 and t.shape[0] % len(devs) == 0
                 else replicate(t, mesh))
        for o, p in zip(out, parts):
            o[k] = p
    return out


def rank_part(x: torch.Tensor, n_local: int) -> torch.Tensor:
    """This process's rows of a global batch tensor whose leading axis is
    the process count x ``n_local``: rows ``rank * n_local`` on (the tensor
    itself without a group)."""
    if not in_group():
        return x
    if x.shape[0] != world_size() * n_local:
        raise ValueError(f"a global draw of {x.shape[0]} rows, expected {world_size()} x "
                         f"{n_local}")
    return x[rank() * n_local:(rank() + 1) * n_local]


def all_reduce_average(tensors: Iterable[torch.Tensor]) -> None:
    """Average ``tensors`` over the group in place, with one all-reduce of
    their concatenation a dtype.  Every process must pass the same shapes in
    the same order.  No-op without a group."""
    if not in_group():
        return
    n = world_size()
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        flat /= n
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def all_reduce_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Average each parameter's ``.grad`` over the group, in place (between
    ``backward()`` and ``optimizer.step()``); a missing gradient counts as
    zero and becomes one.  No-op without a group."""
    if not in_group():
        return
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    all_reduce_average(p.grad for p in params)


def all_reduce_mean(values: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The mean over the group of each 0-d tensor (one all-reduce); the
    values themselves without a group."""
    if not in_group():
        return dict(values)
    n, keys = world_size(), list(values)
    # NCCL reduces card tensors, gloo host ones
    dev = (torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl"
           else torch.device("cpu"))
    stacked = torch.stack([torch.as_tensor(values[k]).detach().to(dev, torch.float32)
                           .reshape(()) for k in keys])
    dist.all_reduce(stacked)
    stacked /= n
    return {k: stacked[i] for i, k in enumerate(keys)}


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the group (a new tensor; x itself without a group)."""
    if not in_group():
        return x
    x = x.clone()
    dist.all_reduce(x)
    return x


def broadcast_object(obj: Any) -> Any:
    """Rank 0's ``obj`` on every process (picklable; as it is without a
    group)."""
    if not in_group():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier() -> None:
    """Wait for every process of the group (no-op without one)."""
    if in_group():
        dist.barrier()
