"""Data-parallel (DDP) and fully sharded (FSDP2) layouts of the port's
multi-process runs (port of the data-parallel half of dpot_tpu/parallel)."""

from dpot_tpu_torch.parallel.mesh import grad_sync, make_mesh, replicate, shard_rows
from dpot_tpu_torch.parallel.multihost import maybe_initialize, rank_world

__all__ = ["grad_sync", "make_mesh", "maybe_initialize", "rank_world", "replicate",
           "shard_rows"]
