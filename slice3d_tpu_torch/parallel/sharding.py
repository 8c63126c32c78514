"""Placing batches on a mesh, parameters sharded over the ``model`` axis,
and what training averages over the process group (the JAX package's
``slice3d_tpu/parallel/sharding.py``).

``shard_batch`` / ``replicate`` are the placements of the JAX package's
``batch_sharding`` / ``replicate``: a tensor's leading axis split over the
mesh's data devices, or the whole tensor on each of them.  ``put_batch``
applies JAX's rule to a batch dict.  Under jit over a sharded batch the JAX
trainers' gradients, logs and BatchNorm statistics are those of the global
batch; here each process computes its local batch's, and
``all_reduce_gradients`` / ``all_reduce_mean`` average them over the group
(``models/layers.py::BatchNorm2d`` reduces its statistics over the data
group itself).  The collectives run whenever a group is joined, a group of
one included, and are no-ops without one.

``shard_params_fsdp`` is JAX's ``shard_params_fsdp`` over the process
mesh's ``model`` axis (``fsdp_spec``: a parameter of at least ``min_size``
elements shards the last axis of its flax layout that the axis size
divides), carried out by torch's ``fully_shard``: a sharded parameter is a
``DTensor`` shard between forwards, so ``state_dict``,
``named_parameters`` and the optimizers hold the shards (an optimizer built
over them keeps its moments in their layout: ``optimizer_groups``), and
each forward of a module that reads one all-gathers it first, so the
modules and the kernels they call see plain tensors.  Its gradient is
reduce-scattered over the model group and averaged over the data group
(DTensor's default ``full_tensor()`` backward would instead keep each
process's own slice of its own gradient, wrong wherever the model group's
processes see different data); ``all_reduce_gradients`` averages the
replicated ones over every process: each gradient is the mean over all
processes, JAX's global-batch gradient.  ``full_state_dict`` /
``load_state_dict_sharded`` and ``full_tensor`` / ``shard_like`` move
between shards and the whole tensors a checkpoint holds (every process
calls the gathering ones).
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard, distribute_tensor

from .mesh import Mesh, ProcessMesh, data_group, data_index, data_size, in_group, world_size

__all__ = ["shard_batch", "replicate", "put_batch", "rank_part", "all_reduce_average",
           "all_reduce_gradients", "all_reduce_mean", "all_reduce_sum", "broadcast_object",
           "barrier", "flax_axes", "fsdp_spec", "fsdp_placements", "shard_params_fsdp",
           "is_sharded", "optimizer_groups", "full_tensor", "shard_like", "full_state_dict",
           "load_state_dict_sharded"]


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
    the data axis's size x ``n_local``: rows ``data_index * n_local`` on, the
    same for every process of a model group (the tensor itself without a
    group)."""
    if not in_group():
        return x
    if x.shape[0] != data_size() * n_local:
        raise ValueError(f"a global draw of {x.shape[0]} rows, expected {data_size()} x "
                         f"{n_local}")
    return x[data_index() * n_local:(data_index() + 1) * n_local]


def all_reduce_average(tensors: Iterable[torch.Tensor], group=None) -> None:
    """Average ``tensors`` over ``group`` (default: the whole group) in
    place, with one all-reduce of their concatenation a dtype.  Every
    process must pass the same shapes in the same order.  No-op without a
    group."""
    if not in_group():
        return
    n = dist.get_world_size(group)
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, group=group)
        flat /= n
        offset = 0
        for t in same:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def all_reduce_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Average each replicated parameter's ``.grad`` over every process, in
    place (between ``backward()`` and ``optimizer.step()``; a sharded one's
    is already the mean, ``shard_params_fsdp``); a missing gradient counts
    as zero and becomes one.  No-op without a group."""
    if not in_group():
        return
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    all_reduce_average(p.grad for p in params if not isinstance(p.grad, DTensor))


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
    """x summed over the data group, the global batch's sum of a statistic
    (a new tensor; x itself without a group)."""
    if not in_group():
        return x
    x = x.clone()
    dist.all_reduce(x, group=data_group())
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


# -- parameters sharded over the model axis (JAX's shard_params_fsdp) -------------------


def flax_axes(module: nn.Module, name: str, p: torch.Tensor) -> Tuple[int, ...]:
    """The axes of ``module``'s parameter ``name`` in the order of its flax
    layout, the inverse of ``convert.py``'s layout map: a conv's (O, I, kH,
    kW) from flax (kH, kW, I, O), a transposed conv's by the same
    transposition, a Linear's (out, in) and ``in_proj_weight`` (the fused
    ``qkv`` kernel) from (in, out), a 1x1 Conv1d's (out, in, 1) from a
    Dense's (in, out) (its unit axis has no flax counterpart), an embedding
    and a vector as they are."""
    if p.dim() <= 1 or isinstance(module, nn.Embedding):
        return tuple(range(p.dim()))
    if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d)) and p.dim() == 4:
        return (2, 3, 1, 0)
    if isinstance(module, nn.Conv1d) and module.kernel_size == (1,) and p.dim() == 3:
        return (1, 0)
    if p.dim() == 2 and (isinstance(module, nn.Linear) or name == "in_proj_weight"):
        return (1, 0)
    raise ValueError(f"no flax layout known for {type(module).__name__}.{name} "
                     f"{tuple(p.shape)}")


def _model_axis(mesh: Union[ProcessMesh, int]) -> int:
    return mesh if isinstance(mesh, int) else mesh.model_size


def fsdp_spec(x, mesh: Union[ProcessMesh, int], min_size: int,
              axes: Optional[Sequence[int]] = None) -> Placement:
    """JAX's ``_fsdp_spec``: ``Replicate()`` when the model axis (``mesh``'s,
    or the size itself) is 1 or ``x`` (a tensor or a shape) has fewer than
    ``min_size`` elements; else ``Shard(axis)`` for the last of ``axes``
    (default: x's own order) whose size the model axis divides;
    ``Replicate()`` when none does."""
    n_model = _model_axis(mesh)
    shape = tuple(x.shape) if hasattr(x, "shape") else tuple(x)
    if n_model <= 1 or not shape or int(np.prod(shape)) < min_size:
        return Replicate()
    for axis in reversed(tuple(range(len(shape))) if axes is None else tuple(axes)):
        if shape[axis] % n_model == 0 and shape[axis] >= n_model:
            return Shard(axis)
    return Replicate()


def fsdp_placements(module: nn.Module, mesh: Union[ProcessMesh, int],
                    min_size: int = 2 ** 16) -> Dict[str, Placement]:
    """The placement ``fsdp_spec`` gives each of ``module``'s parameters, by
    name, over ``mesh``'s model axis (or a model axis of that size)."""
    out = {}
    for mod_name, mod in module.named_modules():
        for name, p in mod.named_parameters(recurse=False):
            full = f"{mod_name}.{name}" if mod_name else name
            out[full] = fsdp_spec(p, mesh, min_size, flax_axes(mod, name, p))
    return out


def _units(module: nn.Module, sharded: Sequence[str]) -> List[nn.Module]:
    """The modules that gather the parameters named ``sharded``: each one's
    outermost ancestor whose class sets ``fsdp_unit`` (a module whose
    parameters are read within its own forward alone, which then gathers
    them in one all-gather), else its owner; a module inside another of
    them is merged into it."""
    modules = dict(module.named_modules())
    picked = set()
    for name in sharded:
        parts = name.split(".")[:-1]
        prefixes = [".".join(parts[:i]) for i in range(len(parts) + 1)]
        picked.add(next((q for q in prefixes if getattr(modules[q], "fsdp_unit", False)),
                        prefixes[-1]))
    outer = [u for u in picked
             if not any(v != u and (v == "" or u.startswith(v + ".")) for v in picked)]
    return [modules[u] for u in sorted(outer)]


def shard_params_fsdp(module: nn.Module, mesh: ProcessMesh,
                      min_size: int = 2 ** 16) -> Dict[str, Placement]:
    """Shard ``module``'s parameters in place over the process mesh's model
    axis by ``fsdp_spec`` (the JAX package's rule, through ``flax_axes``) and
    return the placements by name.  Every process of the mesh calls it on
    the same weights.

    torch's ``fully_shard`` does the work on the (data, model)
    ``DeviceMesh`` (replicated over ``data``, sharded over ``model``), once
    for each module that reads sharded parameters (``_units``); the
    replicated parameters are left as they are (``ignored_params``).  A
    sharded parameter is a ``DTensor`` between forwards, all-gathered over
    the model group before its module's forward and freed after it, and its
    gradient is reduce-scattered over the model group and averaged over the
    data group: the mean over every process.  Shards nothing where the rule
    replicates everything (a model axis of 1)."""
    placements = fsdp_placements(module, mesh, min_size)
    sharded = [n for n, pl in placements.items() if isinstance(pl, Shard)]
    if not sharded:
        return placements
    if mesh.device_mesh is None:
        raise ValueError("sharding needs a process mesh built by init_process_mesh")
    from torch.distributed.fsdp import fully_shard

    params = dict(module.named_parameters())
    by_param = {params[n]: placements[n] for n in sharded}
    ignored = {p for p in params.values() if p not in by_param}
    for unit in _units(module, sharded):
        fully_shard(unit, mesh=mesh.device_mesh, reshard_after_forward=True,
                    shard_placement_fn=by_param.__getitem__, ignored_params=ignored)
    return placements


def is_sharded(module: nn.Module) -> bool:
    """Whether any of ``module``'s parameters is a shard: then a forward, and
    any gather of its state, is a collective of every process."""
    return any(isinstance(p, DTensor) for p in module.parameters())


def optimizer_groups(params: Iterable[torch.nn.Parameter]) -> List[Any]:
    """``params`` for an optimizer: as they are when none is sharded, else
    two groups, the replicated parameters and the shards, in their order
    (torch's multi-tensor updates take one kind a group)."""
    params = list(params)
    shards = [p for p in params if isinstance(p, DTensor)]
    if not shards:
        return params
    plain = [p for p in params if not isinstance(p, DTensor)]
    return [g for g in ({"params": plain}, {"params": shards}) if g["params"]]


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """A shard's whole tensor (gathered over the model group; every process
    calls), or the tensor itself."""
    if isinstance(t, DTensor):
        with torch.no_grad():
            return t.full_tensor()
    return t


def shard_like(ref: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
    """A copy of ``full`` on ``ref``'s device and in its dtype, this process's
    part of it in ``ref``'s placement when ``ref`` is a shard (no
    communication)."""
    full = full.to(ref.device, ref.dtype, copy=True)
    if not isinstance(ref, DTensor):
        return full
    return distribute_tensor(full, ref.device_mesh, ref.placements, src_data_rank=None)


def full_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """``module.state_dict()`` with every shard gathered: the tensors of the
    same module unsharded (every process calls it)."""
    return {k: full_tensor(v) for k, v in module.state_dict().items()}


def load_state_dict_sharded(module: nn.Module, state_dict: Mapping[str, torch.Tensor]) -> None:
    """``module.load_state_dict`` of a whole-tensor state dict (an unsharded
    run's) into a module whose parameters may be sharded: each process keeps
    its part (no communication)."""
    sd = dict(state_dict)
    for name, p in module.named_parameters():
        if isinstance(p, DTensor) and name in sd:
            sd[name] = shard_like(p, sd[name])
    module.load_state_dict(sd)
