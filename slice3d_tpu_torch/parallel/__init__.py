"""Multi-device and multi-process work on ``torch.distributed`` (the JAX
package's ``slice3d_tpu/parallel/``).

``mesh`` builds the (data, model) device grid that reconstruction shards
over, picks it for the CLIs (``reconstruction_mesh``) and joins a process
group (``init_distributed``); ``sharding`` places batches on a mesh and
averages what data-parallel training needs over the group.
"""

from .mesh import (Mesh, create_mesh, default_mesh, device_count, in_group, init_distributed,
                   is_main_process, rank, reconstruction_mesh, world_size)
from .sharding import (all_reduce_average, all_reduce_gradients, all_reduce_mean, all_reduce_sum,
                       barrier, broadcast_object, put_batch, rank_part, replicate, shard_batch)

__all__ = [
    "Mesh",
    "create_mesh",
    "default_mesh",
    "device_count",
    "in_group",
    "init_distributed",
    "is_main_process",
    "rank",
    "reconstruction_mesh",
    "world_size",
    "all_reduce_average",
    "all_reduce_gradients",
    "all_reduce_mean",
    "all_reduce_sum",
    "barrier",
    "broadcast_object",
    "put_batch",
    "rank_part",
    "replicate",
    "shard_batch",
]
