"""Tensor parallelism over the DPOT block stack, the 'model' axis (port of
dpot_tpu/parallel/tensor.py).

JAX annotates the block weights with shardings and lets XLA's partitioner
insert the collectives. Here each rank holds its shards as parameters of
its own (`shard_model_tp`, cut from the full weights after they are
loaded) and the block's forward (`block_forward`) runs on them with c10d
collectives on the 'model' group, written as Megatron's conjugate pairs
(`split`/`gather`, `copy`/`reduce`), each an autograd.Function whose
backward is the other's forward:

- the mixer: each rank takes its C/tp channels, which hold nb/tp whole
  AFNO blocks and norm1's groups / tp whole groups (groups are contiguous
  runs of channels, so their statistics are the full model's), and runs the
  fused GroupNorm + AFNO kernel on them (ops/cuda/afno_fused.py; at DPOT-L,
  C = 768 and 4 groups of 192 channels take afno_hopper_l.cu); its output
  is gathered over 'model';
- norm2 runs on the full channels, then fc1 as a column shard (hidden/tp
  outputs), the activation, fc2 as a row shard into a float32 partial
  product, one all-reduce of it in float32 over 'model', fc2's bias, one
  rounding to the compute dtype, and the residual. A single GEMM rounds
  once too; a sum of bf16 partials would round twice.

Every parameter that is not a shard (norms, embeddings, heads, fc2's bias)
ends a backward with the full model's gradient on every rank: the split of
x and of norm1's affine all-gathers their gradients, the copy before fc1
all-reduces its own. The optimizer's clip (train/optimizers.py) sums the
shards' squared norms over 'model' and counts each replicated leaf once.

`tp_specs` is the counterpart of JAX's `_TP_RULES`/`tp_spec_for` on the
port's state-dict names: blocks.{i}.filter.w1, b1, w2, b2 on the AFNO
block axis 1, blocks.{i}.mlp.0's weight and bias on the hidden axis
(column-parallel) and blocks.{i}.mlp.2's weight on its input axis
(row-parallel), 7 leaves a block. A leaf whose axis tp does not divide
stays replicated, as in JAX; the mixer's four leaves also stay replicated
when tp does not divide norm1's groups (the channel slice must hold whole
groups), and a replicated mixer or MLP runs whole on every rank.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from dpot_tpu_torch.parallel.mesh import Axis, all_gather_dim, all_reduce_

# leaves sharded over 'model', keyed by (parent module, parameter name):
# the axis that is sharded
_TP_RULES = {
    ("filter", "w1"): 1,
    ("filter", "b1"): 1,
    ("filter", "w2"): 1,
    ("filter", "b2"): 1,
    ("mlp.0", "weight"): 0,
    ("mlp.0", "bias"): 0,
    ("mlp.2", "weight"): 1,
}


@dataclasses.dataclass(frozen=True)
class BlockShards:
    """How a block runs under TP: the 'model' axis, and whether its mixer
    and its MLP are sharded (else they run whole on every rank)."""
    axis: Axis
    mixer: bool
    mlp: bool


class _Split(torch.autograd.Function):
    """Forward: this rank's slice along `dim`; backward: the all-gather."""

    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        n = x.shape[dim] // axis.size
        return x.narrow(dim, axis.rank * n, n).clone(memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.dim, ctx.axis), None, None


class _Gather(torch.autograd.Function):
    """Forward: the all-gather along `dim`; backward: this rank's slice."""

    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return all_gather_dim(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim] // ctx.axis.size
        return g.narrow(ctx.dim, ctx.axis.rank * n, n).contiguous(), None, None


class _Copy(torch.autograd.Function):
    """Forward: the identity; backward: the all-reduce (sum)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.axis.group), None


class _Reduce(torch.autograd.Function):
    """Forward: the all-reduce (sum); backward: the identity."""

    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce_(x.clone(), axis.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def split(x: torch.Tensor, axis: Axis, dim: int = -1) -> torch.Tensor:
    return _Split.apply(x, dim % x.dim(), axis)


def gather(x: torch.Tensor, axis: Axis, dim: int = -1) -> torch.Tensor:
    return _Gather.apply(x, dim % x.dim(), axis)


def copy(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return _Copy.apply(x, axis)


def reduce(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return _Reduce.apply(x, axis)


@dataclasses.dataclass
class GroupAffine:
    """norm1 as the mixer reads it (models/dpot.py Block.mix): this rank's
    slices of its affine and its groups among them."""
    weight: torch.Tensor
    bias: torch.Tensor
    num_groups: int
    eps: float


def block_forward(blk, x: torch.Tensor) -> torch.Tensor:
    """The forward of a trunk block (models/dpot.py Block, models/dpot3d.py
    Block3D: `mix` runs norm1 and the mixer, `post_norm` norm2) on this
    rank's shards (module docstring). x: (B, spatial..., C), the same on
    every rank of 'model' (under 'spatial' this rank's rows)."""
    tp = blk.tp
    axis = tp.axis
    n1 = blk.norm1
    if tp.mixer:
        norm = GroupAffine(split(n1.weight, axis), split(n1.bias, axis),
                           n1.num_groups // axis.size, n1.eps)
        y = gather(blk.mix(split(x, axis), norm), axis)
    else:
        y = blk.mix(x, n1)
    h = blk.post_norm(y)
    fc1, act, fc2 = blk.mlp
    if not tp.mlp:
        return fc2(act(fc1(h))) + x
    h = act(fc1(copy(h, axis)))
    dt = fc2.dtype
    w = fc2.weight.reshape(fc2.weight.shape[0], -1).to(dt)
    # the partial product in float32: one rounding after the sum, as one GEMM
    z = F.linear(h.float(), w.float()) if dt != torch.float32 else F.linear(h, w)
    z = reduce(z, axis) + fc2.bias.float()
    return z.to(dt) + x


def _leaf(model: nn.Module, name: str) -> tuple[nn.Module, str]:
    path, leaf = name.rsplit(".", 1)
    return model.get_submodule(path), leaf


def tp_specs(model: nn.Module, tp: int) -> dict[str, int]:
    """The sharded leaves of a model under `tp`-way TP, by state-dict name:
    the axis of each (module docstring). The rules are keyed by names, as
    JAX's: they reach the trunk blocks of DPOTNet, DPOTNet3D and CDPOTNet;
    a model without them (FNO, UNet) stays replicated, as in JAX
    (tests/test_tp.py:62)."""
    specs = {}
    for i, blk in enumerate(getattr(model, "blocks", ())):
        mixer = blk.norm1.num_groups % tp == 0
        for (parent, leaf), dim in _TP_RULES.items():
            name = f"blocks.{i}.{parent}.{leaf}"
            shape = _leaf_tensor(model, name).shape
            if shape[dim] % tp == 0 and (mixer or parent != "filter"):
                specs[name] = dim
    return specs


def _leaf_tensor(model: nn.Module, name: str) -> torch.Tensor:
    mod, leaf = _leaf(model, name)
    return getattr(mod, leaf)


def count_tp_leaves(model: nn.Module, tp: int) -> int:
    """How many leaves carry a 'model' sharding (7 a block for DPOTNet)."""
    return len(tp_specs(model, tp))


def shard_model_tp(model: nn.Module, axis: Axis) -> dict[str, int]:
    """Cut this rank's shards out of the full weights of `model` in place
    (each a contiguous parameter of its own: the kernels' weight cache,
    ops/cuda/afno_fused.py `_cached`, keys on a tensor's address and
    version, so no view of a full tensor may reach it) and set each block to
    run on them; returns `tp_specs`."""
    specs = tp_specs(model, axis.size)
    with torch.no_grad():
        for name, dim in specs.items():
            mod, leaf = _leaf(model, name)
            setattr(mod, leaf, nn.Parameter(local_shard(getattr(mod, leaf), dim, axis)))
    for i, blk in enumerate(getattr(model, "blocks", ())):
        blk.tp = BlockShards(axis, mixer=f"blocks.{i}.filter.w1" in specs,
                             mlp=f"blocks.{i}.mlp.0.weight" in specs)
    model.tp_dims = specs
    return specs


def local_shard(t: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    """This rank's slice of a full tensor along `dim`, contiguous."""
    n = t.shape[dim] // axis.size
    return t.detach().narrow(dim, axis.rank * n, n).clone(memory_format=torch.contiguous_format)


def shard_state_tp(state, mesh):
    """Place `state` (train/state.py TrainState, its weights and moments the
    full model's on every rank) over `mesh`'s 'model' axis in place: the
    parameters and both moments cut to this rank's shards, the clip's norm
    told which leaves are shards, the gradients averaged over 'data' after
    each backward (train/step.py; tp_fsdp then has FSDP2 shard every tensor
    over 'data', train/loop.py place_state). A bf16 working copy
    (train/state.py) becomes this rank's bf16 shards, its f32 master the
    same shards in f32. Returns the state."""
    model, opt = state.model, state.optimizer
    lp = state.params_lp
    if [id(p) for p in model.parameters()] != [id(p) for p in (lp or opt.params)]:
        raise ValueError("the optimizer must update the model's parameters, in order")
    axis = mesh.axis("model")
    names = [n for n, _ in model.named_parameters()]
    specs = shard_model_tp(model, axis)

    def cut(ts):
        return [local_shard(t, specs[n], axis) if n in specs else t for n, t in zip(names, ts)]

    if lp is not None:
        # the working copy is the shards' cast: the bf16 shards cut above,
        # the f32 master cut alike
        opt.params = cut(opt.params)
        state.params_lp = list(model.parameters())
    else:
        opt.params = list(model.parameters())
    opt.mu, opt.nu = cut(opt.mu), cut(opt.nu)
    opt.shard_groups = [(axis.group,) if n in specs else () for n in names]
    state.train_module = model
    state.place_over(mesh, mesh.axis("data").group)
    return state


def gather_tp(t: torch.Tensor, name: str, tp_dims: dict[str, int],
              axis: Axis) -> torch.Tensor:
    """The full tensor of a leaf (a shard gathered over 'model')."""
    dim = tp_dims.get(name)
    return t if dim is None else all_gather_dim(t.detach(), dim, axis)
