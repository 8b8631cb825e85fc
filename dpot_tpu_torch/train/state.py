"""Train state: model, optimizer state, step, noise generator and the
optional low-precision working copy of the parameters (port of
dpot_tpu/train/state.py).

The JAX package carries these as one immutable pytree; here the model's
parameters and the optimizer's moments are updated in place, and the state
object holds them together with the host-side step count and the
`torch.Generator` of the noise stream, which is everything an exact resume
needs (train/checkpoint.py).

On the card a K-step dispatch (train/step.py, `scan_steps`) is a CUDA graph
that reads and writes these tensors by address: they are only ever updated
in place (the loop's rollback copies into them), the generator is
registered with the graph, and `step` and the optimizer's count advance on
the host by K per dispatch.

The working copy (`param_working_dtype=torch.bfloat16`, JAX's `params_lp`)
is a library option, as in the JAX package: no config flag reaches it. The
model's parameters then become the bf16 copy, which the forward and
backward consume, and the optimizer updates float32 master tensors of its
own; after every update the copy is cast again from the master (round to
nearest even). The gradients arrive in bf16 and the optimizer upcasts them
for all of its arithmetic. Checkpoints and the loop's rollback read and
write the master (`params_state_dict`, `load_params`), never the copy.

In a multi-process run (parallel/) `model` stays the module itself, and
`train_module` is what the train step calls: its DistributedDataParallel
wrapper, or the model itself once FSDP2 has sharded it in place
(`sharded`: the parameters and moments are DTensor shards), tensor
parallelism has cut its block weights (the model's `tp_dims`: the sharded
leaves and their axes) or a pipeline stage has kept only its blocks
(parallel/pipeline.py `stage_depth`). `place_over` puts the state on its
mesh: `rank` and `world` are the rank's coordinate on the mesh's 'data'
axis and that axis's size (the rows of a global batch are split over it),
`data_group` its process group (None: the axis has one rank), and
`grad_group`, where set, the group over which the step averages the
gradients after the backward (the layouts that run without DDP's
wrapper). `params_state_dict` and `full_moments` give the full model's
tensors in the reference layout and order whatever the layout: gathering
them is a collective that every rank calls (`gathers`).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

import torch
from torch.distributed.tensor import DTensor

from dpot_tpu_torch.parallel.fsdp import gathered
from dpot_tpu_torch.parallel.pipeline import gather_stages, stage_depth
from dpot_tpu_torch.parallel.tensor import gather_tp
from dpot_tpu_torch.train.optimizers import Optimizer


def _local(ts: list) -> list:
    """This rank's shards of DTensors (views), other tensors as they are."""
    return [t.to_local() if isinstance(t, DTensor) else t for t in ts]


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Optimizer
    generator: torch.Generator
    step: int = 0
    # the model's parameters when they are a low-precision working copy of
    # the optimizer's f32 master (in the same order), else None
    params_lp: Optional[list[torch.Tensor]] = None
    # the module the train step calls (DDP's wrapper of `model`, or `model`
    # under FSDP2); None: `model` itself, in one process
    train_module: Optional[torch.nn.Module] = None
    rank: int = 0
    world: int = 1
    sharded: bool = False
    data_group: Optional[object] = None
    grad_group: Optional[object] = None
    # the mesh (parallel/mesh.py) of a multi-process run
    mesh: Optional[object] = None

    @classmethod
    def create(cls, model: torch.nn.Module, optimizer: Optimizer, seed: int,
               param_working_dtype: Optional[torch.dtype] = None) -> "TrainState":
        """State at step 0; the noise generator lives on the model's device,
        seeded with `seed`. With `param_working_dtype` the optimizer, built
        over `model.parameters()`, keeps f32 masters of them and the model's
        parameters become their copy in that dtype."""
        device = next(model.parameters()).device
        gen = torch.Generator(device=device).manual_seed(seed)
        state = cls(model=model, optimizer=optimizer, generator=gen)
        if param_working_dtype is not None:
            state._make_working_copy(param_working_dtype)
        return state

    @property
    def forward_module(self) -> torch.nn.Module:
        """The module a train step's forward and backward go through."""
        return self.model if self.train_module is None else self.train_module

    @torch.no_grad()
    def _make_working_copy(self, dtype: torch.dtype) -> None:
        if dtype != torch.bfloat16:
            # the fused mixer takes f32 or bf16 weights, and the dense layers
            # cast theirs to the compute type
            raise ValueError(f"the working copy is bfloat16, not {dtype}")
        params = list(self.model.parameters())
        if [id(p) for p in params] != [id(p) for p in self.optimizer.params]:
            raise ValueError("the optimizer must update the model's parameters, in order")
        if any(p.dtype != torch.float32 for p in params):
            raise ValueError("the working copy is made of float32 parameters")
        if any(True for _ in self.model.buffers()):
            # as in JAX, which refuses it for a tree with batch_stats
            raise ValueError("the working copy does not take a model with buffers "
                             "(UNet's BatchNorm statistics)")
        self.optimizer.params = [p.detach().clone() for p in params]
        for p in params:
            p.data = p.data.to(dtype)
        self.params_lp = params

    @torch.no_grad()
    def refresh_working_copy(self) -> None:
        """Cast the working copy again from the f32 master (round to nearest
        even, as JAX's astype); sharded, shard by shard (no collective)."""
        if self.params_lp is not None:
            torch._foreach_copy_(_local(self.params_lp), _local(self.optimizer.params))

    def apply_gradients(self, grads: Optional[Sequence[Optional[torch.Tensor]]] = None,
                        values: Optional[torch.Tensor] = None) -> None:
        """One optimizer update from `grads` (one per parameter, None for
        zero), by default the model parameters' .grad, with the update's
        per-step scalars `values` (Optimizer.step); then the working copy,
        if any, follows the master."""
        if grads is None and self.params_lp is not None:
            grads = [p.grad for p in self.params_lp]
        self.optimizer.step(grads, values)
        self.refresh_working_copy()
        self.step += 1

    def mutated(self) -> list[torch.Tensor]:
        """The tensors a train step writes that the forward reads: the
        model's parameters, its buffers (UNet's running statistics, which a
        train-mode forward updates) and, with a working copy, the f32
        master."""
        params = list(self.model.parameters()) + list(self.model.buffers())
        return params + list(self.optimizer.params) if self.params_lp is not None else params

    def place_over(self, mesh, grad_group=None) -> None:
        """Put the state on `mesh` (parallel/mesh.py Mesh): this rank's
        place on its 'data' axis (the module docstring), and the group over
        which the step averages the gradients (None: none, or DDP's or
        FSDP2's own sync)."""
        data = mesh.axis("data")
        self.mesh, self.grad_group = mesh, grad_group
        self.rank, self.world, self.data_group = data.rank, data.size, data.group

    @property
    def gathers(self) -> bool:
        """Whether the full tensors are gathered over the ranks (FSDP2, TP or
        a pipeline), a collective that every rank calls."""
        return (self.sharded or bool(getattr(self.model, "tp_dims", None))
                or stage_depth(self.model) > 0)

    def _full(self, tensors: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """The full model's tensors from this rank's, by name: FSDP2's
        gathered, TP shards gathered over 'model', a stage's blocks over
        'pipe', in the reference order."""
        out = {k: gathered(v) for k, v in tensors.items()}
        tp_dims = getattr(self.model, "tp_dims", None)
        if tp_dims:
            axis = self.mesh.axis("model")
            out = {k: gather_tp(v, k, tp_dims, axis) for k, v in out.items()}
        per = stage_depth(self.model)
        if per:
            out = gather_stages(list(out.items()), self.mesh.axis("pipe"), per)
        return out

    def params_state_dict(self) -> dict[str, torch.Tensor]:
        """The model's state dict with the f32 master in place of the working
        copy (under every name a parameter has): the weights that
        checkpoints save. Sharded tensors come back whole."""
        sd = dict(self.model.state_dict())
        if self.params_lp is not None:
            master = {id(p): m for p, m in zip(self.params_lp, self.optimizer.params)}
            for name, p in self.model.named_parameters(remove_duplicate=False):
                sd[name] = master[id(p)].detach()
        return self._full(sd)

    def full_moments(self) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
        """The optimizer's moments of the full model, in its parameters'
        order (a collective under a layout that `gathers`)."""
        names = [n for n, _ in self.model.named_parameters()]
        mu = self._full(dict(zip(names, self.optimizer.mu)))
        nu = self._full(dict(zip(names, self.optimizer.nu)))
        return list(mu.values()), list(nu.values())

    @torch.no_grad()
    def load_params(self, sd: Mapping[str, torch.Tensor]) -> None:
        """Load a full state dict of the model (strict): into the f32 master,
        and the working copy cast from it, when there is one."""
        self.model.load_state_dict(sd, strict=True)
        if self.params_lp is not None:
            for (name, _), master in zip(self.model.named_parameters(), self.optimizer.params):
                master.copy_(sd[name])
            self.refresh_working_copy()
