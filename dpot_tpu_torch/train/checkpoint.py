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

The file is written beside its target and renamed into place, so a crash
mid-write leaves the previous checkpoint whole. `save_checkpoint` takes the
state's CPU copies (and the generator's state) synchronously; with an
`AsyncCheckpointWriter` the write to disk (`torch.save`, the rename,
config.json) then runs on the writer's thread while training goes on
(JAX's writer, dpot_tpu/train/checkpoint.py:121-175), else in the call.

In a multi-process run the checkpoint is the single-process one: the
module's own state dict (no DDP 'module.' prefix) and the full moments, in
the reference layout under every layout (train/state.py
`params_state_dict`, `full_moments`). Rank 0 alone writes it; under FSDP2,
TP or a pipeline every rank calls `save_checkpoint`, since gathering the
shards is a collective (`TrainState.gathers`). A restore happens on every rank
before the state is placed over the ranks (train/loop.py), so a checkpoint
written by N ranks resumes on any number of them.

`restore_params` reads only the weights (evaluation, serving, warm starts);
`load_components` copies whole units of a source state dict into a target
one, for fine-tuning (reference utils/utilities.py:112-166).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import queue
import threading
from typing import Mapping, Optional, Sequence

import torch

from dpot_tpu_torch.parallel.multihost import rank_world
from dpot_tpu_torch.train.interop import load_reference_state_dict, strip_module_prefix
from dpot_tpu_torch.train.state import TrainState
from dpot_tpu_torch.utils.profiling import host_fetch

MODEL_FILE = "model.pth"


def _write_payload(path: str, payload: dict, config: Optional[dict]) -> str:
    """Write a checkpoint directory from a host payload; returns the model
    file's path."""
    os.makedirs(path, exist_ok=True)
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


class AsyncCheckpointWriter:
    """Checkpoint writes on a worker thread, so that a large save does not
    stall the step loop. `submit` hands over a host payload and blocks
    while an earlier one is still queued (at most one waits, so host memory
    holds at most two payloads); it first raises the error of a write that
    failed. `wait` returns once every write submitted is on disk, or raises
    a failed one's error. `close` (also on leaving a `with` block) waits and
    always stops the thread."""

    def __init__(self):
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, name="checkpoint-writer",
                                        daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                _write_payload(*item)
            except BaseException as e:  # raised in the caller's thread
                self._err = e
            finally:
                self._q.task_done()

    def _check(self) -> None:
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError("asynchronous checkpoint write failed") from err

    def submit(self, path: str, payload: dict, config: Optional[dict]) -> None:
        self._check()
        self._q.put((path, payload, config))

    def wait(self) -> None:
        self._q.join()
        self._check()

    def close(self) -> None:
        if not self._thread.is_alive():
            return
        try:
            self.wait()
        finally:
            # stop the worker even when a write failed
            self._q.put(None)
            self._thread.join()

    def __enter__(self) -> "AsyncCheckpointWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def save_checkpoint(path: Optional[str], state: TrainState, config: Optional[dict] = None,
                    writer: Optional[AsyncCheckpointWriter] = None) -> Optional[str]:
    """Write the checkpoint directory `path`; returns the model file's path
    (with `writer`, where the thread will write it). Only rank 0 writes (the
    others return None, and may pass path None); under a layout whose state
    is sharded every rank calls it, since the gather is a collective. The
    payload's CPU copies and the generator's state are taken in the call;
    with `writer` only the write to disk is left to its thread."""
    opt = state.optimizer
    mu, nu = state.full_moments()
    config = copy.deepcopy(config)
    payload = host_fetch({
        "args": argparse.Namespace(**(config or {})),
        "model": state.params_state_dict(),
        "optimizer": {"count": opt.count, "mu": mu, "nu": nu, "grad_norm": opt.grad_norm},
        "step": int(state.step),
        "generator": state.generator.get_state(),
    })
    if rank_world()[0] != 0:
        return None
    if writer is None:
        return _write_payload(path, payload, config)
    writer.submit(path, payload, config)
    return os.path.join(path, MODEL_FILE)


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
# state-dict prefixes of the same modules here ("{i}" is a block's index).
# JAX matches its names by prefix (dpot_tpu/train/checkpoint.py
# load_components), so a family's units are the names of its own layout that
# JAX's prefixes reach: DPOT and DPOT3D as below; FNO reaches patch_embed and
# the cls_head layers (its other names, like UNet's, match no prefix, and
# the prefixes find no such keys here either).
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
# CDPOT's head (dpot_tpu/train/interop.py cdpot_params_from_torch):
# out_layer.0 is the CNO block, JAX's `out_cno`, which no prefix of "out"
# matches; its two convs are out_layer.1 and out_layer.3
CDPOT_COMPONENT_PREFIXES = {
    **COMPONENT_PREFIXES,
    "out": (("out_conv1", "out_layer.1."), ("out_conv2", "out_layer.3.")),
}


def component_prefixes(sd: Mapping[str, torch.Tensor]) -> dict:
    """The units of the family whose state dict `sd` is: CDPOT's where its
    out_layer.0 is a CNO block (a `convolution` under it), else DPOT's."""
    if any(k.startswith("out_layer.0.convolution.") for k in sd):
        return CDPOT_COMPONENT_PREFIXES
    return COMPONENT_PREFIXES


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
    subtrees. 'all', alone or in the list, selects every component. The
    units are those of the target's family (`component_prefixes`). Returns
    the merged state dict and the copied units under their JAX names, in
    the target's order."""
    table = component_prefixes(target)
    if components == "all" or "all" in components:
        components = tuple(table)
    depth = 1 + max((int(k.split(".")[1]) for k in target if k.startswith("blocks.")),
                    default=-1)
    units = []
    for c in components:
        for name, prefix in table[c]:
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
