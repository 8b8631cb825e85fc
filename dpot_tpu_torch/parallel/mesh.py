"""The data axis of the port's multi-process runs (port of the data-parallel
half of dpot_tpu/parallel/mesh.py).

JAX builds one mesh over every device and shards the global batch over its
'data' axis; XLA inserts the gradient psums. Here each rank is one process
on one device, the mesh is a 1-D `DeviceMesh` over the ranks (FSDP2 shards
over it), each rank holds its rows of the global batch, and the gradients
are summed over the ranks by DDP's all-reduce (`replicate`) or FSDP2's
reduce-scatter (parallel/fsdp.py). The 'spatial', 'model' and 'pipe' axes
are not ported (ROADMAP, 'Modules to port', item 12).

A global batch whose rows do not divide over the ranks is not sharded:
every rank computes all of it (`shard_rows` returns None), which costs
`world` times the compute of that batch. As in the JAX package such
fallbacks warn once and are counted (`shard_rows.fallbacks`), so that a
caller can check that none happens on its steady path.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Optional

import torch
import torch.distributed as dist

from dpot_tpu_torch.parallel.multihost import rank_world


def make_mesh(data: Optional[int] = None, device: str | torch.device = "cuda"):
    """A 1-D DeviceMesh named 'data' over every rank of the default process
    group, which must be up. `data` is None or the world size: one rank per
    device."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the default process group "
                           "(parallel/multihost.py maybe_initialize, under torchrun)")
    world = check_mesh_data(data, rank_world()[1])
    return init_device_mesh(torch.device(device).type, (world,), mesh_dim_names=("data",))


def check_mesh_data(data: Optional[int], world: int) -> int:
    """The data axis's size: `data` (mesh_data) is None or the world size,
    one rank per device."""
    if data not in (None, world):
        raise ValueError(f"mesh_data={data} does not match the {world} ranks: one rank "
                         "per device, so mesh_data is the world size (or unset)")
    return world


def shard_rows(n: int, rank: int, world: int) -> Optional[slice]:
    """Rank `rank`'s contiguous rows of an n-row global batch, or None when
    n does not divide over the `world` ranks: the replicated fallback, in
    which every rank takes all n rows (warned once, counted)."""
    if n % world:
        shard_rows.fallbacks += 1
        if shard_rows.fallbacks == 1:
            warnings.warn(f"global batch of {n} rows does not divide over {world} ranks; "
                          "every rank computes it whole (correct, but world times the "
                          "compute). Pick a batch size that divides.", stacklevel=2)
        return None
    per = n // world
    return slice(rank * per, (rank + 1) * per)


shard_rows.fallbacks = 0


def replicate(module: torch.nn.Module, ignore: tuple[str, ...] = ()) -> torch.nn.Module:
    """`module` under DistributedDataParallel over the default group: its
    parameters and buffers broadcast from rank 0 at the wrap (DDP's own
    sync), its gradients averaged over the ranks in the backward. The
    parameters named under the prefixes `ignore` (those that the loss does
    not reach, train/step.py UNTRAINED) are left out of DDP's reducer, so
    that their missing gradients do not stall it, and broadcast here."""
    from torch.nn.parallel import DistributedDataParallel as DDP

    names = [n for n, _ in module.named_parameters() if n.startswith(ignore)]
    params = dict(module.named_parameters())
    with torch.no_grad():
        for n in names:
            dist.broadcast(params[n].data, src=0)
    DDP._set_params_and_buffers_to_ignore_for_model(module, names)
    dev = next(module.parameters()).device
    return DDP(module, device_ids=[dev] if dev.type == "cuda" else None,
               broadcast_buffers=False)


@contextlib.contextmanager
def grad_sync(module: torch.nn.Module, enabled: bool):
    """Within the block, a backward through `module` syncs its gradients over
    the ranks (enabled) or only accumulates them locally (DDP's no_sync,
    FSDP2's requires_gradient_sync off), for all but the last microbatch of
    an accumulation. A module that is neither is left alone."""
    from torch.distributed.fsdp import FSDPModule
    from torch.nn.parallel import DistributedDataParallel as DDP

    if isinstance(module, DDP) and not enabled:
        with module.no_sync():
            yield
    elif isinstance(module, FSDPModule):
        module.set_requires_gradient_sync(enabled)
        try:
            yield
        finally:
            module.set_requires_gradient_sync(True)
    else:
        yield
