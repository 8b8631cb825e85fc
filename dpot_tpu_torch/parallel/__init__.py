"""The port's multi-process layouts (port of dpot_tpu/parallel): the mesh
and its data axis (DDP), FSDP2, tensor parallelism over 'model', the GPipe
pipeline over 'pipe' and the pencil-FFT mixer over 'spatial'."""

from dpot_tpu_torch.parallel.mesh import Mesh, grad_sync, make_mesh, replicate, shard_rows
from dpot_tpu_torch.parallel.multihost import maybe_initialize, rank_world

__all__ = ["Mesh", "grad_sync", "make_mesh", "maybe_initialize", "rank_world", "replicate",
           "shard_rows"]
