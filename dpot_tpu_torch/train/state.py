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
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

import torch

from dpot_tpu_torch.train.optimizers import Optimizer


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Optimizer
    generator: torch.Generator
    step: int = 0
    # the model's parameters when they are a low-precision working copy of
    # the optimizer's f32 master (in the same order), else None
    params_lp: Optional[list[torch.Tensor]] = None

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
        even, as JAX's astype)."""
        if self.params_lp is not None:
            torch._foreach_copy_(self.params_lp, self.optimizer.params)

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

    def params_state_dict(self) -> dict[str, torch.Tensor]:
        """The model's state dict with the f32 master in place of the working
        copy (under every name a parameter has): the weights that
        checkpoints save."""
        sd = self.model.state_dict()
        if self.params_lp is not None:
            master = {id(p): m for p, m in zip(self.params_lp, self.optimizer.params)}
            for name, p in self.model.named_parameters(remove_duplicate=False):
                sd[name] = master[id(p)].detach()
        return sd

    @torch.no_grad()
    def load_params(self, sd: Mapping[str, torch.Tensor]) -> None:
        """Load a full state dict of the model (strict): into the f32 master,
        and the working copy cast from it, when there is one."""
        self.model.load_state_dict(sd, strict=True)
        if self.params_lp is not None:
            for (name, _), master in zip(self.model.named_parameters(), self.optimizer.params):
                master.copy_(sd[name])
            self.refresh_working_copy()
