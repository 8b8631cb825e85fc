"""Checkpoints of the full train state with `torch.save` (port of the
save/restore half of dpot_tpu/train/checkpoint.py; orbax checkpoints of the
JAX package are not read).

A checkpoint is a directory holding
- `model.pth`: a reference-layout file {'args', 'model', 'optimizer'}, so
  that `dpot_tpu_torch.cli.serve --resume_path .../model.pth` and
  `train/interop.py:load_reference_checkpoint` load it as they load a
  released reference checkpoint, plus the keys an exact resume needs:
  'step' and 'generator' (the noise stream's state). 'optimizer' holds the
  moments and count. Tensors are saved on the CPU.
- `config.json`: the run's config.

Writes are synchronous: the file is written beside its target and renamed
into place, so a crash mid-write leaves the previous checkpoint whole.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import torch

from dpot_tpu_torch.train.interop import strip_module_prefix
from dpot_tpu_torch.train.state import TrainState

MODEL_FILE = "model.pth"


def _cpu(t):
    return t.detach().cpu() if isinstance(t, torch.Tensor) else t


def save_checkpoint(path: str, state: TrainState, config: Optional[dict] = None) -> str:
    """Write the checkpoint directory `path`; returns the model file's path."""
    os.makedirs(path, exist_ok=True)
    opt = state.optimizer.state_dict()
    payload = {
        "args": argparse.Namespace(**(config or {})),
        "model": {k: _cpu(v) for k, v in state.model.state_dict().items()},
        "optimizer": {"count": opt["count"], "mu": [_cpu(m) for m in opt["mu"]],
                      "nu": [_cpu(v) for v in opt["nu"]],
                      "grad_norm": _cpu(opt["grad_norm"])},
        "step": int(state.step),
        "generator": state.generator.get_state(),
    }
    target = os.path.join(path, MODEL_FILE)
    tmp = f"{target}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, target)
    if config is not None:
        tmp = os.path.join(path, f"config.json.{os.getpid()}.tmp")
        with open(tmp, "w") as f:
            json.dump(config, f, indent=1, default=str)
        os.replace(tmp, os.path.join(path, "config.json"))
    return target


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load a checkpoint (its directory or its model.pth) into `state` in
    place: parameters, moments, step and generator."""
    target = os.path.join(path, MODEL_FILE) if os.path.isdir(path) else path
    with torch.serialization.safe_globals([argparse.Namespace]):
        obj = torch.load(target, map_location="cpu", weights_only=True)
    for key in ("optimizer", "step", "generator"):
        if key not in obj:
            raise ValueError(
                f"{target} holds no '{key}': it is a weights-only reference "
                "checkpoint, which cannot resume a run"
            )
    state.model.load_state_dict(strip_module_prefix(obj["model"]), strict=True)
    state.optimizer.load_state_dict(obj["optimizer"])
    state.step = int(obj["step"])
    state.generator.set_state(obj["generator"])
    return state
