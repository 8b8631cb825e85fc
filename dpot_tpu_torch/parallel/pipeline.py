"""GPipe over the trunk's depth, the 'pipe' axis (port of
dpot_tpu/parallel/pipeline.py).

Stage r of P holds only blocks [r L/P, (r+1) L/P) (`StageBlocks`, which keeps
their canonical names blocks.{i}, so checkpoints do not change), and with
them 1/P of the trunk's weights and moments. Every stage computes the
embedding and the heads on the whole batch (they are replicated); the trunk
runs as the GPipe schedule of JAX's `pipeline_blocks`: M microbatches (0:
one per stage; degraded to a divisor of the batch), M + P - 1 ticks, at
each of which a stage applies its blocks to the microbatch it holds and
passes the result on to the next stage (`permute`). The JAX stages also
compute the bubble ticks and throw the results away; here a stage skips
them, so each application launches exactly M x L/P block forwards a rank
(twice that under remat, which applies per block as in JAX).

The schedule is one autograd.Function (`_Trunk`) whose backward runs the
reverse schedule: the last stage takes the gradient of the trunk's output,
each stage back-propagates its microbatches through its blocks in reverse
tick order and passes the input gradient back to the previous stage (the
reverse permute, the permute's adjoint). Running the collectives from one
schedule keeps their order the same on every stage, which autograd's own
traversal of graphs that differ between stages would not. The last stage's
output is broadcast, so every stage computes the heads and the loss; the
first stage's input gradient is broadcast back, so every stage's embedding
gets it: every replicated parameter ends the backward with one process's
gradient on every stage, and a stage's blocks with theirs (never the sum
over stages of a loss that each computes, which would be P times the
heads' gradient).

The permute is an all_gather_into_tensor over the 'pipe' group, from which
each stage takes the slot of the stage before it: P times the bytes of a
point-to-point send, and a collective that gloo carries with CUDA tensors
(tools/gloo_cuda_collectives.py), as it does the broadcast
(tools/gloo_cuda_layouts.py).
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from dpot_tpu_torch.parallel.mesh import Axis, as_words, gather_stacked


class StageBlocks(nn.Module):
    """A stage's blocks under their canonical indices (blocks.{i}.*);
    iterates over them in order."""

    def __init__(self, blocks: dict[int, nn.Module]):
        super().__init__()
        for i, blk in blocks.items():
            self.add_module(str(i), blk)

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self) -> int:
        return len(self._modules)


def micro_count(batch: int, n_micro: int) -> int:
    """The microbatches of a batch: n_micro, or fewer, down to a divisor of
    the batch (a bigger bubble, never a wrong answer)."""
    n = max(1, min(n_micro, batch))
    while n > 1 and batch % n:
        n -= 1
    return n


def permute(t: torch.Tensor, axis: Axis, shift: int) -> torch.Tensor:
    """Each stage's t passed `shift` stages on: stage r gets stage r - shift's."""
    return gather_stacked(t, axis)[(axis.rank - shift) % axis.size]


def from_stage(t: torch.Tensor, axis: Axis, src: int) -> torch.Tensor:
    """Stage src's t on every stage (a broadcast over 'pipe')."""
    t = t.contiguous()
    dist.broadcast(as_words(t), src=dist.get_global_rank(axis.group, src), group=axis.group)
    return t


class _Schedule:
    """The GPipe schedule of one stage's blocks over 'pipe' (module
    docstring)."""

    def __init__(self, blocks: list[nn.Module], axis: Axis, n_micro: int, remat: bool):
        self.blocks, self.axis, self.n_micro, self.remat = blocks, axis, n_micro, remat

    def _apply(self, x: torch.Tensor, grad: bool) -> torch.Tensor:
        for blk in self.blocks:
            # a block draws no random numbers, so its recomputation needs no
            # saved RNG state
            x = (checkpoint(blk, x, use_reentrant=False, preserve_rng_state=False)
                 if self.remat and grad else blk(x))
        return x

    def forward(self, x: torch.Tensor, grad: bool):
        """The trunk's output on every stage; with `grad`, also each
        microbatch's input (a leaf) and output (with its graph) here."""
        P, s = self.axis.size, self.axis.rank
        M = micro_count(x.shape[0], self.n_micro)
        xs = x.chunk(M)
        mb = xs[0].shape[0]
        ins, outs = [None] * M, [None] * M
        y = torch.zeros_like(x)
        cur = None
        for t in range(M + P - 1):
            m = t - s
            out = None
            if 0 <= m < M:
                inp = xs[m] if s == 0 else cur
                if grad:
                    inp = inp.detach().requires_grad_()
                with torch.enable_grad() if grad else contextlib.nullcontext():
                    out = self._apply(inp, grad)
                if grad:
                    ins[m], outs[m] = inp, out
                if s == P - 1:
                    y[m * mb:(m + 1) * mb] = out.detach()
            if t < M + P - 2:
                cur = permute(xs[0].new_zeros(xs[0].shape) if out is None else out.detach(),
                              self.axis, 1)
        return from_stage(y, self.axis, P - 1), ins, outs

    def backward(self, g: torch.Tensor, ins: list, outs: list, params: list):
        """The reverse schedule: the gradient of the trunk's input (the first
        stage's, on every stage) and of this stage's parameters."""
        P, s = self.axis.size, self.axis.rank
        M = len(ins)
        gs = g.chunk(M)
        mb = gs[0].shape[0]
        gx = torch.zeros_like(g)
        acc: list = [None] * len(params)
        cur = None
        for tau in range(M + P - 1):
            m = tau - (P - 1 - s)
            gin = None
            if 0 <= m < M:
                gout = gs[m] if s == P - 1 else cur
                res = torch.autograd.grad(outs[m], [ins[m], *params], gout, allow_unused=True)
                gin = res[0]
                acc = [a if r is None else r if a is None else a + r
                       for a, r in zip(acc, res[1:])]
                ins[m] = outs[m] = None
                if s == 0:
                    gx[m * mb:(m + 1) * mb] = gin
            if tau < M + P - 2:
                cur = permute(gs[0].new_zeros(gs[0].shape) if gin is None else gin,
                              self.axis, -1)
        return from_stage(gx, self.axis, 0), acc


class _Trunk(torch.autograd.Function):
    """The schedule as one differentiable op of the trunk's input and this
    stage's parameters."""

    @staticmethod
    def forward(ctx, x, schedule, *params):
        y, ins, outs = schedule.forward(x, grad=True)
        ctx.schedule, ctx.ins, ctx.outs, ctx.params = schedule, ins, outs, params
        return y

    @staticmethod
    def backward(ctx, g):
        gx, gp = ctx.schedule.backward(g, ctx.ins, ctx.outs, list(ctx.params))
        ctx.ins = ctx.outs = None
        return (gx, None, *gp)


def pipeline_blocks(blocks: list[nn.Module], x: torch.Tensor, axis: Axis, n_micro: int,
                    remat: bool = False) -> torch.Tensor:
    """x (B, h, w, D), the same on every stage, through the trunk whose
    blocks are spread over 'pipe' (this stage's `blocks`): the output of
    the last block, on every stage."""
    schedule = _Schedule(blocks, axis, n_micro, remat)
    if not torch.is_grad_enabled():
        return schedule.forward(x, grad=False)[0]
    params = [p for blk in blocks for p in blk.parameters() if p.requires_grad]
    return _Trunk.apply(x, schedule, *params)


def shard_state_pipe(state, mesh):
    """Place `state` (train/state.py TrainState, the full model's weights and
    moments on every rank) over `mesh`'s 'pipe' axis in place: each stage
    keeps only its blocks' parameters and moments (and their bf16 working
    copy and f32 master), the clip's norm sums the blocks' squared norms
    over 'pipe' and counts the replicated leaves once, and the gradients
    are averaged over 'data' after each backward (train/step.py; under
    `fsdp` FSDP2 then shards the stage's tensors over 'data' instead,
    train/loop.py place_state, JAX's tests/test_pipeline.py:149). Returns
    the state."""
    model, opt = state.model, state.optimizer
    lp = state.params_lp
    if [id(p) for p in model.parameters()] != [id(p) for p in (lp or opt.params)]:
        raise ValueError("the optimizer must update the model's parameters, in order")
    axis = mesh.axis("pipe")
    names = [n for n, _ in model.named_parameters()]
    model.cut_stage()
    keep = {n for n, _ in model.named_parameters()}

    def kept(ts):
        return [t for n, t in zip(names, ts) if n in keep]

    if lp is not None:  # the stage's blocks' copy and master
        opt.params = kept(opt.params)
        state.params_lp = list(model.parameters())
    else:
        opt.params = list(model.parameters())
    opt.mu, opt.nu = kept(opt.mu), kept(opt.nu)
    # a stage's blocks are spread over 'pipe' (and TP shards, if cut
    # before, over 'model' too)
    groups = opt.shard_groups or [()] * len(names)
    opt.shard_groups = [g + ((axis.group,) if n.startswith("blocks.") else ())
                        for n, g in zip(names, groups) if n in keep]
    state.train_module = model
    state.place_over(mesh, mesh.axis("data").group)
    return state


def stage_depth(model: nn.Module) -> int:
    """The blocks a pipeline stage keeps (`StageBlocks`), 0 when the model
    holds its whole trunk."""
    blocks = getattr(model, "blocks", None)
    return len(blocks) if isinstance(blocks, StageBlocks) else 0


def gather_stages(named: list[tuple[str, torch.Tensor]], axis: Axis,
                  per: int) -> dict[str, torch.Tensor]:
    """The full model's tensors from each stage's (name, tensor) pairs, in
    the reference order: a block's tensor gathered over 'pipe' (the
    stages' blocks of one position have one shape) under the name of each
    stage's block, between the tensors before and after the trunk, as they
    are (a collective that every stage calls)."""
    head, tail, blocks = [], [], {}
    for name, t in named:
        if name.startswith("blocks."):
            _, i, rest = name.split(".", 2)
            blocks[int(i) % per, rest] = gather_stacked(t.detach(), axis)
        else:
            (tail if blocks else head).append((name, t))
    full = [(f"blocks.{q * per + j}.{rest}", v[q])
            for q in range(axis.size) for (j, rest), v in blocks.items()]
    return dict(head + full + tail)
