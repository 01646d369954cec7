"""Multi-process data parallelism (port of ``endoscopy_tpu/parallel/``).

One process per card under ``torchrun``: NCCL on ``cuda:LOCAL_RANK``, gloo
on the CPU when the caller asks for it. ``mesh.py`` forms the group and
checks ``TRAIN.MESH_DATA``/``MESH_MODEL``; ``sharding.py`` holds the
collectives the trainers issue.
"""

from endoscopy_tpu_torch.parallel.mesh import (Group, current_group,
                                               group_rank, group_size,
                                               in_group,
                                               init_from_env, leave_group,
                                               mesh_from_config)
from endoscopy_tpu_torch.parallel.sharding import (all_gather_rows,
                                                   all_reduce_max,
                                                   all_reduce_min,
                                                   all_reduce_sum, barrier,
                                                   batch_mean,
                                                   broadcast_state,
                                                   flip_rows, global_mean,
                                                   local_rows, sync_grads)

__all__ = ["Group", "all_gather_rows", "all_reduce_max", "all_reduce_min",
           "all_reduce_sum", "barrier", "batch_mean", "broadcast_state",
           "current_group", "flip_rows", "global_mean", "group_rank",
           "group_size", "in_group", "init_from_env", "leave_group", "local_rows",
           "mesh_from_config", "sync_grads"]
