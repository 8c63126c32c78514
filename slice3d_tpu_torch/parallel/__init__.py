"""Multi-device and multi-process work on ``torch.distributed`` (the JAX
package's ``slice3d_tpu/parallel/``).

``mesh`` builds the (data, model) device grid that reconstruction shards
over, picks it for the CLIs (``reconstruction_mesh``), joins a process
group (``init_distributed``) and lays the group out as a (data, model)
process mesh (``init_process_mesh``); ``sharding`` places batches on a
mesh, shards parameters over the ``model`` axis by the JAX package's rule
(``shard_params_fsdp``) and averages what training needs over the group.
"""

from .mesh import (Mesh, ProcessMesh, create_mesh, data_group, data_index, data_size,
                   default_mesh, device_count, in_group, init_distributed, init_process_mesh,
                   is_main_process, model_group, model_index, process_mesh, rank,
                   reconstruction_mesh, world_size)
from .sharding import (all_reduce_average, all_reduce_gradients, all_reduce_mean, all_reduce_sum,
                       barrier, broadcast_object, flax_axes, fsdp_placements, fsdp_spec,
                       full_state_dict, full_tensor, is_sharded, load_state_dict_sharded,
                       optimizer_groups, put_batch, rank_part, replicate, shard_batch,
                       shard_like, shard_params_fsdp)

__all__ = [
    "Mesh",
    "ProcessMesh",
    "create_mesh",
    "data_group",
    "data_index",
    "data_size",
    "default_mesh",
    "device_count",
    "in_group",
    "init_distributed",
    "init_process_mesh",
    "is_main_process",
    "model_group",
    "model_index",
    "process_mesh",
    "rank",
    "reconstruction_mesh",
    "world_size",
    "all_reduce_average",
    "all_reduce_gradients",
    "all_reduce_mean",
    "all_reduce_sum",
    "barrier",
    "broadcast_object",
    "flax_axes",
    "fsdp_placements",
    "fsdp_spec",
    "full_state_dict",
    "full_tensor",
    "is_sharded",
    "load_state_dict_sharded",
    "optimizer_groups",
    "put_batch",
    "rank_part",
    "replicate",
    "shard_batch",
    "shard_like",
    "shard_params_fsdp",
]
