"""Fully sharded parameters and optimizer moments (port of
dpot_tpu/parallel/fsdp.py) with FSDP2 (`torch.distributed.fsdp.fully_shard`).

JAX annotates every large parameter and both Adam moments with a sharding
over the 'data' axis and lets XLA all-gather the parameters for the forward
and backward and reduce-scatter the gradients. Here `shard_state_fsdp` puts
each trunk block, then the root module, under FSDP2: every parameter
becomes a DTensor sharded over the ranks, the forward and backward of each
block all-gather its parameters and free them afterwards, and the backward
reduce-scatters the gradients, which arrive as sharded DTensors. The
optimizer's moments are re-made as DTensors with their parameters'
placements, and train/optimizers.py updates the local shards, with one
all-reduce of the squared gradient norm for the clip.

Each tensor is sharded over its first axis when the world size divides it,
else over its largest axis that it divides (the axis JAX's `shape_spec`
picks), else over the first axis unevenly. JAX keeps leaves under 2**16
elements and leaves with no divisible axis replicated (`param_spec`);
FSDP2 shards every one of them. The numbers computed do not change: the
gathered parameter is the same tensor either way.

Under FSDP2 the all-gather writes the gathered values into the same
unsharded parameter, at what is usually the same address, and keeps its
version counter; the Hopper kernels' cache of converted weights
(ops/cuda/afno_fused.py `_cached`), keyed on both, would then serve
the previous step's weights. So `no_block_cache` gives every AFNO module of
a sharded model a forward pre-hook that marks the weights it is about to
read (the gathered ones) as not to be cached, and the kernels convert them
on every call.

The bf16 working copy (train/state.py `params_lp`) shards as the model's
parameters do: FSDP2 shards the bf16 copy, its f32 master is sharded with
the same placements, and the optimizer updates the master's local shards,
from which the copy's local shards are cast again (no collective). FSDP2
then all-gathers bf16 shards that are the master's cast, which is JAX's
"cast, then gather" (dpot_tpu/train/state.py:101-104), and reduce-scatters
the ranks' gradients in float32 (`MixedPrecisionPolicy(reduce_dtype=
float32)`), rounding the sum once to bf16, the working copy's gradient
dtype in the JAX step (dpot_tpu/train/step.py:236-242). Each rank's
gradient is bf16 before that sum (autograd gives a bf16 parameter a bf16
gradient), where JAX's float32-compute layout sums the float32 cotangent
before its cast: over a split batch the two differ by a bf16 rounding of
the gradient.

Under a pipeline (parallel/pipeline.py) FSDP2 wraps the stage's model
alone, not each block: the stage's parameters are gathered once before the
schedule and stay so through its backward, whose autograd.Function hands
their gradients to FSDP2's reduce-scatter at the end.

`gathered` assembles a sharded tensor with c10d's all-gather of the local
shards, not DTensor's `full_tensor`, which crashes over gloo with CUDA
tensors (tools/gloo_cuda_collectives.py), so a sharded checkpoint is
written over either backend.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard, distribute_tensor

from dpot_tpu_torch.parallel.mesh import Axis, gather_stacked


def _shard_dim(shape: torch.Size, world: int) -> int:
    """The axis a tensor is sharded over (module docstring)."""
    if not shape or shape[0] % world == 0:
        return 0
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[i] % world == 0:
            return i
    return 0


def gathered(t):
    """The full tensor of a DTensor sharded over one mesh axis (a collective
    every rank of it calls), else t: each rank's local shard padded to
    torch.chunk's size along the sharded axis, all-gathered with c10d, the
    shards concatenated in rank order and the padding cut off."""
    if not isinstance(t, DTensor):
        return t
    (place,) = t.placements
    local = t.to_local().detach()
    if place.is_replicate():
        return local
    dim, n = place.dim, t.shape[place.dim]
    group = t.device_mesh.get_group()
    world = dist.get_world_size(group)
    chunk = -(-n // world)
    if local.shape[dim] < chunk:
        pad = list(local.shape)
        pad[dim] = chunk - local.shape[dim]
        local = torch.cat([local, local.new_zeros(pad)], dim)
    parts = gather_stacked(local, Axis(group, world, dist.get_rank(group)))
    return torch.cat(parts.unbind(0), dim).narrow(dim, 0, n)


def shard_like(full: torch.Tensor, like: DTensor) -> DTensor:
    """A full tensor that every rank holds, sharded as `like` is, each rank
    keeping its own slice (no collective)."""
    return distribute_tensor(full.detach().to(like.device), like.device_mesh, like.placements,
                             src_data_rank=None)


def _mark_uncached(module, args) -> None:
    module.w1._dpot_block_cache = module.w2._dpot_block_cache = False


def no_block_cache(model) -> None:
    """Before each forward of an AFNO module of `model`, mark the w1 and w2
    it reads (FSDP2's gathered parameters) so that the kernels convert
    them afresh (ops/cuda/afno_fused.py `_cached`)."""
    from dpot_tpu_torch.models.dpot import AFNO2D

    for m in model.modules():
        if isinstance(m, AFNO2D):
            m.register_forward_pre_hook(_mark_uncached)


def shard_state_fsdp(state, mesh, grad_group=None):
    """Shard the model's parameters and the optimizer's moments of `state`
    (train/state.py TrainState, its parameters identical on every rank:
    seeded or restored, or already this rank's tensor-parallel shards or
    pipeline stage) over the 'data' axis of `mesh` (parallel/mesh.py Mesh)
    in place, and with them the f32 master of a working copy; returns the
    state. `grad_group`: the groups over which the step still averages the
    gradients after FSDP2's reduce-scatter ('spatial', train/loop.py
    place_state), else None."""
    from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard

    from dpot_tpu_torch.parallel.pipeline import stage_depth

    model, opt = state.model, state.optimizer
    lp = state.params_lp
    if [id(p) for p in model.parameters()] != [id(p) for p in (lp or opt.params)]:
        raise ValueError("the optimizer must update the model's parameters, in order")
    data = mesh.axis("data")
    world = data.size

    def placement(p):
        return Shard(_shard_dim(p.shape, world))

    kw = dict(mesh=mesh.data_mesh, shard_placement_fn=placement)
    if lp is not None:
        kw["mp_policy"] = MixedPrecisionPolicy(reduce_dtype=torch.float32)
    if not stage_depth(model):
        for blk in getattr(model, "blocks", ()):
            fully_shard(blk, **kw)
    fully_shard(model, **kw)
    no_block_cache(model)
    params = list(model.parameters())
    if lp is not None:
        opt.params = [shard_like(m, p) for m, p in zip(opt.params, params)]
        state.params_lp = params
    else:
        opt.params = params
    opt.mu = [shard_like(m, p) for m, p in zip(opt.mu, params)]
    opt.nu = [shard_like(v, p) for v, p in zip(opt.nu, params)]
    state.train_module = model
    state.place_over(mesh, grad_group)
    state.sharded = True
    return state


def check_fsdp_shardings(state) -> list[str]:
    """The parameters and moments of a sharded `state` that are not sharded
    over the ranks: not DTensors, or holding more than their share on this
    rank where an axis divides over the ranks. Empty means good."""
    world = state.world
    names = [n for n, _ in state.model.named_parameters()]
    opt = state.optimizer
    bad = []
    for tag, ts in (("param", opt.params), ("mu", opt.mu), ("nu", opt.nu)):
        for name, t in zip(names, ts, strict=True):
            divisible = any(s % world == 0 for s in t.shape)
            if not isinstance(t, DTensor) or (
                    divisible and t.to_local().numel() * world > t.numel()):
                bad.append(f"{tag} {name}")
    return bad
