"""Multi-device: meshes, sharding rules, differentiable collectives, halo
exchange and frame-sharded temporal modules over ``torch.distributed``.

Counterpart of ``flair_tpu/parallel/`` (the reference's DDP backbone,
dist_util.py:21-92, train_util.py:125-132). JAX lets GSPMD insert every
collective; here they are explicit, and every rank is called with the same
host inputs, keeps its own shard and returns the whole result.
"""

from .collectives import (
    all_gather_frames,
    all_reduce_mean,
    mesh_barrier,
    sum_over_mesh_,
)
from .mesh import (
    axis_size,
    batch_sharding,
    is_first_rank,
    make_mesh,
    replicate_params,
    replicated,
    shard,
    shard_batch,
)
from .halo import halo_exchange_frames
from .frame_sharded import (
    frame_sharded,
    frame_sharded_temporal_attention,
    set_frame_group,
)
from .world import LocalWorld
