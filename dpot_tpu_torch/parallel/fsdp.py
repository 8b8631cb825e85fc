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
version counter; the bf16 Hopper kernels' cache of converted weights
(ops/cuda/afno_fused.py `_bf16_blocks`), keyed on both, would then serve
the previous step's weights. So `no_block_cache` gives every AFNO module of
a sharded model a forward pre-hook that marks the weights it is about to
read (the gathered ones) as not to be cached, and the kernels convert them
on every call. The bf16 working copy of the parameters (train/state.py
`params_lp`) is refused under FSDP.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard, distribute_tensor



def _shard_dim(shape: torch.Size, world: int) -> int:
    """The axis a tensor is sharded over (module docstring)."""
    if not shape or shape[0] % world == 0:
        return 0
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[i] % world == 0:
            return i
    return 0


def gathered(t):
    """The full tensor of a DTensor (a collective every rank calls), else t.
    Refused over gloo with CUDA tensors, where full_tensor crashes the
    process (tools/gloo_cuda_collectives.py on the H100): FSDP2 trains
    there, but its state is gathered over nccl."""
    if not isinstance(t, DTensor):
        return t
    if t.device.type == "cuda" and dist.get_backend(t.device_mesh.get_group()) == "gloo":
        raise RuntimeError("gathering a sharded tensor over gloo with CUDA tensors crashes "
                           "the process: launch with nccl (one rank a card) to checkpoint "
                           "a sharded run")
    return t.full_tensor()


def shard_like(full: torch.Tensor, like: DTensor) -> DTensor:
    """A full tensor that every rank holds, sharded as `like` is, each rank
    keeping its own slice (no collective)."""
    return distribute_tensor(full.detach().to(like.device), like.device_mesh, like.placements,
                             src_data_rank=None)


def _mark_uncached(module, args) -> None:
    module.w1._dpot_block_cache = module.w2._dpot_block_cache = False


def no_block_cache(model) -> None:
    """Before each forward of an AFNO module of `model`, mark the w1 and w2
    it reads (FSDP2's gathered parameters) so that the bf16 kernels convert
    them afresh (ops/cuda/afno_fused.py `_bf16_blocks`)."""
    from dpot_tpu_torch.models.dpot import AFNO2D

    for m in model.modules():
        if isinstance(m, AFNO2D):
            m.register_forward_pre_hook(_mark_uncached)


def shard_state_fsdp(state, mesh):
    """Shard the model's parameters and the optimizer's moments of `state`
    (train/state.py TrainState, its parameters identical on every rank:
    seeded or restored, or already this rank's tensor-parallel shards) over
    the 'data' axis of `mesh` (parallel/mesh.py Mesh) in place; returns the
    state."""
    from torch.distributed.fsdp import fully_shard

    if state.params_lp is not None:
        raise NotImplementedError(
            "the bf16 working copy (param_working_dtype) under shard_params=fsdp is not "
            "ported yet (ROADMAP, 'Modules to port', item 12)")
    model, opt = state.model, state.optimizer
    if [id(p) for p in model.parameters()] != [id(p) for p in opt.params]:
        raise ValueError("the optimizer must update the model's parameters, in order")
    data = mesh.axis("data")
    world = data.size

    def placement(p):
        return Shard(_shard_dim(p.shape, world))

    for blk in getattr(model, "blocks", ()):
        fully_shard(blk, mesh=mesh.data_mesh, shard_placement_fn=placement)
    fully_shard(model, mesh=mesh.data_mesh, shard_placement_fn=placement)
    no_block_cache(model)
    opt.params = list(model.parameters())
    opt.mu = [shard_like(m, p) for m, p in zip(opt.mu, opt.params)]
    opt.nu = [shard_like(v, p) for v, p in zip(opt.nu, opt.params)]
    state.train_module = model
    state.place_over(mesh)
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
