"""Process groups of the port's multi-process runs (port of
dpot_tpu/parallel/multihost.py).

The reference launches N processes with `accelerate launch`
(parallel_trainer.py:66), the JAX package one controller per host and
`jax.distributed.initialize()`. The port runs one process per card under
torchrun:

    torchrun --nproc_per_node N -m dpot_tpu_torch.cli.train --config_file ...

torchrun sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT,
and `maybe_initialize` starts the default process group from them: nccl
for CUDA ranks and gloo for CPU ones unless the caller names the backend
(gloo with CUDA tensors is how two ranks share one card, which nccl
refuses). Each rank then loads its contiguous slice of every global batch
(data/loader.py `num_shards`, `shard_index`). A batch that does not split
evenly over the ranks (an epoch's tail) goes whole to every rank, which
computes it whole: the JAX package's all-gather of the host slices
(`_allgather_host_slices`) with the gather done by the loader, so no
collective is needed and no rank gets an empty slice.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

# what torchrun sets for every rank
LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def default_backend(device: str | torch.device | None) -> str:
    """nccl for CUDA ranks, gloo for CPU ones."""
    return "nccl" if torch.device(device or "cuda").type == "cuda" else "gloo"


def maybe_initialize(backend: Optional[str] = None,
                     device: str | torch.device | None = None,
                     timeout: Optional[float] = None) -> bool:
    """Start the default process group when torchrun's variables are set
    (`backend` by default `default_backend(device)`, `timeout` in seconds).
    A no-op returning False without them; True, and nothing done, when the
    group is up already."""
    if dist.is_initialized():
        return True
    if not all(k in os.environ for k in LAUNCH_ENV):
        return False
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend or default_backend(device), init_method="env://", **kw)
    return True


def rank_world() -> tuple[int, int]:
    """(rank, world size) of the default group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1
