"""The mesh of the port's multi-process runs (port of dpot_tpu/parallel/mesh.py).

JAX builds one mesh over every device with four axes and lets XLA insert
the collectives:

  data    - batch (DDP, or FSDP2 over it: parallel/fsdp.py)
  pipe    - the trunk's depth in stages (GPipe, parallel/pipeline.py)
  spatial - the latent's H axis (the pencil FFT, parallel/dist_fft.py)
  model   - tensor parallelism over the block weights (parallel/tensor.py)

Here each rank is one process on one device. `make_mesh` lays the ranks out
as the JAX package does, `arange(world).reshape(data, pipe, spatial, model)`
('model' innermost), as a `DeviceMesh` over the axes of size above 1 (and
'data' always), which gives each rank one process group per axis, the
ranks that differ from it only along that axis. The collectives of the
layouts are c10d's on those groups, called by every rank of a group in the
same order; DTensor appears only where FSDP2 shards (its functional
collectives crash over gloo with CUDA tensors, tools/gloo_cuda_collectives.py).

Each rank loads the rows of its data coordinate (`shard_rows`): the ranks
that differ only in 'pipe', 'model' or 'spatial' load the same rows, and
under 'spatial' each then keeps its own H rows. A global batch whose rows
do not divide over the data axis is not sharded: every rank computes all of
it (`shard_rows` returns None), which costs the data size times the compute
of that batch. As in the JAX package such fallbacks warn once and are
counted (`shard_rows.fallbacks`), so that a caller can check that none
happens on its steady path.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import warnings
from typing import Optional

import torch
import torch.distributed as dist

from dpot_tpu_torch.parallel.multihost import rank_world

AXES = ("data", "pipe", "spatial", "model")


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of the mesh as this rank sees it: the process group of its
    row (None when the axis has one rank), the row's size and this rank's
    coordinate along it."""
    group: Optional[dist.ProcessGroup]
    size: int
    rank: int


class Mesh:
    """The four axes over the ranks of the default process group (see the
    module docstring); `device_mesh` is the DeviceMesh over the axes of size
    above 1 and 'data', `data_mesh` its 1-D 'data' slice (FSDP2's mesh)."""

    def __init__(self, sizes: dict[str, int], device: torch.device):
        from torch.distributed.device_mesh import init_device_mesh

        self.sizes = dict(sizes)
        self.device = torch.device(device)
        names = tuple(a for a in AXES if a == "data" or sizes[a] > 1)
        self.device_mesh = init_device_mesh(self.device.type, tuple(sizes[a] for a in names),
                                            mesh_dim_names=names)
        rank = rank_world()[0]
        self.coords = {}
        for a in reversed(AXES):
            self.coords[a] = rank % sizes[a]
            rank //= sizes[a]

    def size(self, axis: Optional[str] = None) -> int:
        """An axis's size, or the number of ranks."""
        return math.prod(self.sizes.values()) if axis is None else self.sizes[axis]

    def axis(self, name: str) -> Axis:
        n = self.sizes[name]
        group = self.device_mesh.get_group(name) if n > 1 else None
        return Axis(group, n, self.coords[name])

    @property
    def data_mesh(self):
        return self.device_mesh["data"]


def make_mesh(data: Optional[int] = None, spatial: int = 1, model: int = 1, pipe: int = 1,
              device: str | torch.device = "cuda") -> Mesh:
    """The mesh over every rank of the default process group, which must be
    up: `data` None takes the ranks that the other axes leave."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the default process group "
                           "(parallel/multihost.py maybe_initialize, under torchrun)")
    data = check_mesh_data(data, rank_world()[1], spatial * model * pipe)
    return Mesh(dict(data=data, pipe=pipe, spatial=spatial, model=model), device)


def check_mesh_data(data: Optional[int], world: int, others: int = 1) -> int:
    """The data axis's size: the product of the axes (`others` that of
    'pipe', 'spatial' and 'model') is the world size, one rank per device;
    `data` (mesh_data) None takes what the other axes leave."""
    if others > 1 and (world % others or data not in (None, world // others)):
        raise ValueError(f"the mesh axes (mesh_data={data} x {others} over mesh_pipe, "
                         f"mesh_spatial and mesh_model) do not make the {world} ranks: one "
                         "rank per device, so their product is the world size (mesh_data "
                         "unset takes what the others leave)")
    if data not in (None, world // others):
        raise ValueError(f"mesh_data={data} does not match the {world} ranks: one rank per "
                         "device, so mesh_data is the world size (or unset)")
    return world // others


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


def as_words(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes as a dtype that every backend moves: bf16
    as uint8 (the last axis doubled; gloo's all-to-all refuses int16), so
    that a collective that only moves data (a gather, a broadcast, an
    all-to-all) does not depend on gloo's support for bf16; `from_words`
    views them back."""
    return t.view(torch.uint8) if t.dtype == torch.bfloat16 else t


def from_words(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.view(dtype) if dtype == torch.bfloat16 else t


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over the group's ranks in place; a low-precision float is
    summed in float32 and rounded once."""
    if t.dtype in (torch.bfloat16, torch.float16):
        t32 = t.float()
        dist.all_reduce(t32, group=group)
        return t.copy_(t32)
    dist.all_reduce(t, group=group)
    return t


def all_gather_dim(t: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    """The axis's ranks' tensors of one shape concatenated along `dim`, in
    rank order (c10d's all_gather_into_tensor)."""
    if axis.size == 1:
        return t
    return torch.cat(gather_stacked(t, axis).unbind(0), dim=dim)


def gather_stacked(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The axis's ranks' tensors of one shape stacked (size, *t.shape), in
    rank order (c10d's all_gather_into_tensor, bf16 moved as words)."""
    w = as_words(t.contiguous().reshape(1, -1))
    out = w.new_empty((axis.size, w.shape[1]))
    dist.all_gather_into_tensor(out, w, group=axis.group)
    return from_words(out, t.dtype).reshape(axis.size, *t.shape)


class _AllSum(torch.autograd.Function):
    """Forward: the sum over the axis's ranks; backward: the same sum of the
    incoming gradients. Each rank's loss is then its part of one objective,
    the sum over the ranks (models/dpot.py, spatial)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


def all_sum(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """t summed over the axis's ranks, differentiably (`_AllSum`)."""
    return t if axis.size == 1 else _AllSum.apply(t, axis.group)


def all_reduce_mean(ts: list[torch.Tensor], group=None, n: Optional[int] = None) -> None:
    """ts averaged over the group's ranks in place, in one all-reduce (sum,
    then divided by `n`, by default the group's size); low-precision floats
    are summed in float32 and rounded once, DTensors as their local shards."""
    from torch.distributed.tensor import DTensor

    ts = [t.to_local() if isinstance(t, DTensor) else t for t in ts]
    if not ts:
        return
    wide = torch.float32 if any(t.dtype in (torch.bfloat16, torch.float16) for t in ts) else None
    flat = torch.cat([t.reshape(-1).to(wide or t.dtype) for t in ts])
    dist.all_reduce(flat, group=group)
    flat /= n or dist.get_world_size(group)
    for t, f in zip(ts, flat.split([t.numel() for t in ts])):
        t.copy_(f.view_as(t))


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
