"""Checkpoints of the full train state with `torch.save` (port of the
save/restore half of dpot_tpu/train/checkpoint.py; orbax checkpoints of the
JAX package are not read).

A checkpoint is a directory holding
- `model.pth`: a reference-layout file {'args', 'model', 'optimizer'}
  ('model' the f32 weights: the master, never a bf16 working copy, which
  a restore casts again from it), so
  that `restore_params` (and with it the serve, evaluate and finetune
  CLIs) reads it as it reads a released reference checkpoint, plus the
  keys an exact resume needs:
  'step' and 'generator' (the noise stream's state). 'optimizer' holds the
  moments and count. Tensors are saved on the CPU.
- `config.json`: the run's config.

Writes are synchronous: the file is written beside its target and renamed
into place, so a crash mid-write leaves the previous checkpoint whole.

`restore_params` reads only the weights (evaluation, serving, warm starts);
`load_components` copies whole units of a source state dict into a target
one, for fine-tuning (reference utils/utilities.py:112-166).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Mapping, Optional, Sequence

import torch

from dpot_tpu_torch.train.interop import load_reference_state_dict, strip_module_prefix
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
        "model": {k: _cpu(v) for k, v in state.params_state_dict().items()},
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
    state.load_params(strip_module_prefix(obj["model"]))
    state.optimizer.load_state_dict(obj["optimizer"])
    state.step = int(obj["step"])
    state.generator.set_state(obj["generator"])
    return state


def restore_params(path: str) -> dict[str, torch.Tensor]:
    """The model's state dict (on the CPU) from a checkpoint directory that
    the port wrote, its model.pth, or a reference-layout .pth."""
    if os.path.isdir(path):
        target = os.path.join(path, MODEL_FILE)
        if not os.path.isfile(target):
            raise FileNotFoundError(
                f"{path} is a directory without {MODEL_FILE}: expected a checkpoint "
                f"directory that the port wrote ({MODEL_FILE} and config.json) or a "
                "reference-layout .pth")
        path = target
    return load_reference_state_dict(path)


# fine-tuning units: the JAX package's top-level parameter names and the
# state-dict prefixes of the same modules here ("{i}" is a block's index)
COMPONENT_PREFIXES = {
    "blocks": (("blocks_{i}", "blocks.{i}."),),
    "pos": (("pos_embed", "pos_embed"),),
    "patch_embed": (("patch_embed", "patch_embed."),),
    "scale_feats": (("scale_feats_mu", "scale_feats_mu."),
                    ("scale_feats_sigma", "scale_feats_sigma.")),
    "cls_head": (("cls_head_0", "cls_head.0."), ("cls_head_1", "cls_head.2."),
                 ("cls_head_2", "cls_head.4.")),
    "time_agg": (("time_agg", "time_agg_layer."),),
    "out": (("out_deconv", "out_layer.0."), ("out_conv1", "out_layer.2."),
            ("out_conv2", "out_layer.4.")),
}


def _unit_keys(sd: Mapping[str, torch.Tensor], prefix: str) -> list[str]:
    """The keys of one unit: `prefix` itself (a bare parameter) or the keys
    under it; "blocks.1." does not take "blocks.10."."""
    return [k for k in sd if k == prefix or (prefix.endswith(".") and k.startswith(prefix))]


def load_components(
    target: Mapping[str, torch.Tensor],
    source: Mapping[str, torch.Tensor],
    components: Sequence[str] | str = ("blocks", "pos", "time_agg"),
) -> tuple[dict[str, torch.Tensor], list[str]]:
    """Copy the selected components of `source` into a copy of `target`
    (state dicts), a unit at a time: a unit (one block, one head layer, the
    position embedding, ...) is copied only when the source has the same
    keys under it with the same shapes, as the JAX package compares whole
    subtrees. 'all', alone or in the list, selects every component. Returns
    the merged state dict and the copied units under their JAX names, in
    the target's order."""
    if components == "all" or "all" in components:
        components = tuple(COMPONENT_PREFIXES)
    depth = 1 + max((int(k.split(".")[1]) for k in target if k.startswith("blocks.")),
                    default=-1)
    units = []
    for c in components:
        for name, prefix in COMPONENT_PREFIXES[c]:
            n = depth if "{i}" in name else 1
            units += [(name.format(i=i), prefix.format(i=i)) for i in range(n)]
    order = {k: i for i, k in enumerate(target)}
    merged = dict(target)
    copied = []
    for name, prefix in units:
        keys = _unit_keys(target, prefix)
        if not keys or sorted(_unit_keys(source, prefix)) != sorted(keys):
            continue
        if all(source[k].shape == target[k].shape for k in keys):
            merged.update({k: source[k] for k in keys})
            copied.append((min(order[k] for k in keys), name))
    return merged, [name for _, name in sorted(copied)]
