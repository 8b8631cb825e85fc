"""Train state: model, optimizer state, step and noise generator (port of
dpot_tpu/train/state.py).

The JAX package carries these as one immutable pytree; here the model's
parameters and the optimizer's moments are updated in place, and the state
object holds them together with the host-side step count and the
`torch.Generator` of the noise stream, which is everything an exact resume
needs (train/checkpoint.py).
"""

from __future__ import annotations

import dataclasses

import torch

from dpot_tpu_torch.train.optimizers import Optimizer


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Optimizer
    generator: torch.Generator
    step: int = 0

    @classmethod
    def create(cls, model: torch.nn.Module, optimizer: Optimizer, seed: int,
               param_working_dtype=None) -> "TrainState":
        """State at step 0; the noise generator lives on the model's device,
        seeded with `seed`."""
        if param_working_dtype is not None:
            raise NotImplementedError(
                "a low-precision working copy of the params (params_lp) is not "
                "ported yet (ROADMAP, 'Modules to port', item 8)"
            )
        device = next(model.parameters()).device
        gen = torch.Generator(device=device).manual_seed(seed)
        return cls(model=model, optimizer=optimizer, generator=gen)

    def apply_gradients(self) -> None:
        """One optimizer update from the parameters' .grad."""
        self.optimizer.step()
        self.step += 1
