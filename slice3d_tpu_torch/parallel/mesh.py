"""The device mesh, the process group and the process mesh (the JAX
package's ``slice3d_tpu/parallel/mesh.py``).

A mesh is a (data, model) grid of devices, as ``jax.sharding.Mesh`` with
the axis names ``("data", "model")``.  Reconstruction shards its object
batch or each head call's query points over the ``data`` axis, one model
replica a distinct device; a device may appear more than once (two replicas'
work on one card, or ``["cpu", "cpu"]`` in tests), and repeats share the
replica.

Training runs one process per card, torch's idiom, where a JAX process
spreads over every local chip: ``init_distributed`` joins the processes
named by ``SLICE3D_COORDINATOR`` / ``SLICE3D_NUM_PROCESSES`` /
``SLICE3D_PROCESS_ID`` into one ``torch.distributed`` group (NCCL on cards,
gloo when the caller asks for the CPU), and process ``p`` takes card
``p % torch.cuda.device_count()``.  The group's processes form a (data,
model) grid, the ``ProcessMesh``: ``init_process_mesh((data, model))``
builds it over the group (``init_device_mesh``, rank ``d * model + m`` at
``(d, m)``) and makes it the current one.  The processes of one data row
(a model group) read the same batch rows and hold one copy of the
parameters between them, those that ``sharding.shard_params_fsdp`` splits
over ``model``; the data groups (one a model index) reduce the batch
statistics.  Without ``init_process_mesh`` the grid is (processes, 1), the
data-parallel training of every CLI (the JAX CLIs shard nothing over
``model`` either), and without a group it is (1, 1), where every
accessor is a no-op.  The port's ``dryrun`` builds the one ``model`` axis
larger than 1 outside tests.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "create_mesh", "default_mesh", "reconstruction_mesh", "device_count",
           "init_distributed", "in_group", "world_size", "rank", "is_main_process",
           "ProcessMesh", "init_process_mesh", "process_mesh", "data_index", "data_size",
           "data_group", "model_index", "model_group"]

Device = Union[str, torch.device]


class Mesh:
    """``devices``: an object array of ``torch.device`` of shape (data,
    model)."""

    axis_names = ("data", "model")

    def __init__(self, devices: np.ndarray):
        self.devices = devices

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def data_devices(self) -> List[torch.device]:
        """The devices along the data axis (the first of each model row)."""
        return list(self.devices[:, 0])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.ravel()]})"


def _visible_cards() -> List[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def create_mesh(shape: Optional[Tuple[int, int]] = None,
                devices: Optional[Sequence[Device]] = None) -> Mesh:
    """A (data, model) mesh over ``devices`` (default: every visible card);
    ``shape=None`` puts all of them on the data axis."""
    devs = [torch.device(d) for d in devices] if devices is not None else _visible_cards()
    n = len(devs)
    if shape is None:
        shape = (n, 1)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape))


def default_mesh() -> Mesh:
    return create_mesh()


def reconstruction_mesh(shard_axis: str, batch_size: int, chunk_size: int, n_dev: int,
                        devices: Optional[Sequence[Device]] = None) -> Optional[Mesh]:
    """The mesh policy of the reconstruct, serve and slice-dump CLIs.

    points: shard each object's query axis (needs chunk_size % n_dev == 0,
    the JAX package's rule, kept although the port deals whole head calls
    to the devices: see ``pipeline.Reconstructor``); batch: shard the
    object batch (needs batch_size > 1 divisible by n_dev).  Returns a mesh
    over ``devices`` (default: the first ``n_dev`` cards) or None; warns
    when an explicit points request cannot be honoured rather than
    silently falling back."""
    if n_dev <= 1:
        return None
    devs = list(devices) if devices is not None else _visible_cards()[:n_dev]
    if shard_axis == "points":
        if chunk_size % n_dev != 0:
            print(f"warning: --mc_shard_axis points ignored — "
                  f"mc_chunk_size {chunk_size} not divisible by "
                  f"{n_dev} devices")
            return None
        return create_mesh((n_dev, 1), devs)
    if batch_size > 1 and batch_size % n_dev == 0:
        return create_mesh((n_dev, 1), devs)
    return None


def device_count(device: Device) -> int:
    """The devices a CLI on ``device`` may shard over: every visible card
    for a CUDA device, 1 for the CPU."""
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else 1


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *, device: Device = "cuda",
                     timeout_s: float = 300.0) -> int:
    """Join the process group of a multi-process run; returns the process
    count.

    The values default from ``SLICE3D_COORDINATOR`` (``host:port`` of
    process 0) / ``SLICE3D_NUM_PROCESSES`` / ``SLICE3D_PROCESS_ID``; without
    a coordinator or with one process this is a no-op returning 1.  On the
    card (``device`` CUDA, the default) the group is NCCL's and process
    ``p`` takes card ``p % device_count`` as its current device; with
    ``device="cpu"`` it is gloo's.  A group already joined is kept."""
    coordinator = coordinator or os.environ.get("SLICE3D_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("SLICE3D_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("SLICE3D_PROCESS_ID", "0"))
    if not coordinator or num_processes <= 1:
        return 1
    if dist.is_initialized():
        return dist.get_world_size()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group("nccl" if cuda else "gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return num_processes


def in_group() -> bool:
    """Whether a process group is joined.  The collectives run whenever one
    is, a group of one process included."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Processes in the group (1 without one)."""
    return dist.get_world_size() if in_group() else 1


def rank() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if in_group() else 0


def is_main_process() -> bool:
    """Rank 0: the process that writes checkpoints, options and logs."""
    return rank() == 0


class ProcessMesh:
    """The (data, model) grid of the process group.

    ``device_mesh``: the ``torch.distributed`` ``DeviceMesh`` over the group
    with the dimension names ``("data", "model")`` (None for the default
    grid, which shards nothing).  This process sits at (``data_index``,
    ``model_index``); ``data_group`` holds the processes of its model index
    (the batch statistics reduce over it; the whole group when ``model`` is
    1, so a data-parallel run keeps its arithmetic) and ``model_group`` those
    of its data index (the sharded parameters gather over it)."""

    axis_names = ("data", "model")

    def __init__(self, shape: Tuple[int, int], device_mesh=None):
        self.data_size, self.model_size = (int(shape[0]), int(shape[1]))
        self.device_mesh = device_mesh
        self._world = dist.group.WORLD if in_group() else None
        if device_mesh is None:
            self.data_index, self.model_index = rank(), 0
        else:
            self.data_index = device_mesh.get_local_rank("data")
            self.model_index = device_mesh.get_local_rank("model")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, (self.data_size, self.model_size)))

    @property
    def data_group(self):
        if self._world is None or self.model_size == 1:
            return self._world
        return self.device_mesh["data"].get_group()

    @property
    def model_group(self):
        return None if self.device_mesh is None else self.device_mesh["model"].get_group()

    def current(self) -> bool:
        """Whether the group it was built over is still the joined one."""
        return (dist.group.WORLD if in_group() else None) is self._world

    def __repr__(self) -> str:
        return (f"ProcessMesh({self.shape}, at ({self.data_index}, {self.model_index}), "
                f"{'a DeviceMesh' if self.device_mesh is not None else 'no DeviceMesh'})")


# the process's one mesh, as torch.distributed's default group is the
# process's one group: BatchNorm and the loader read it without a caller
_PROCESS_MESH: Optional[ProcessMesh] = None


def init_process_mesh(shape: Optional[Tuple[int, int]] = None) -> ProcessMesh:
    """Build the (data, model) ``ProcessMesh`` over the joined group (every
    process calls it; ``shape`` defaults to (processes, 1)) and make it the
    current one.  Without a group only (1, 1) is possible, the grid of one
    process."""
    global _PROCESS_MESH
    n = world_size()
    shape = (n, 1) if shape is None else (int(shape[0]), int(shape[1]))
    if shape[0] * shape[1] != n:
        raise ValueError(f"process mesh {shape} over {n} processes")
    device_mesh = None
    if in_group():
        from torch.distributed.device_mesh import init_device_mesh

        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        device_mesh = init_device_mesh(device_type, shape, mesh_dim_names=ProcessMesh.axis_names)
    _PROCESS_MESH = ProcessMesh(shape, device_mesh)
    return _PROCESS_MESH


def process_mesh() -> ProcessMesh:
    """The current process mesh: the last ``init_process_mesh``'s while its
    group is joined, else the default grid (processes, 1)."""
    global _PROCESS_MESH
    if _PROCESS_MESH is None or not _PROCESS_MESH.current():
        _PROCESS_MESH = ProcessMesh((world_size(), 1))
    return _PROCESS_MESH


def data_index() -> int:
    """This process's index on the data axis (its batch shard)."""
    return process_mesh().data_index


def data_size() -> int:
    """The data axis's size: the batch shards of a global batch."""
    return process_mesh().data_size


def data_group():
    """The processes that share this process's model index (None without a
    group): the batch statistics' all-reduces run over it."""
    return process_mesh().data_group


def model_index() -> int:
    return process_mesh().model_index


def model_group():
    """The processes of this process's data index (None without a
    ``DeviceMesh``): the sharded parameters gather over it."""
    return process_mesh().model_group
