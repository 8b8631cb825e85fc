"""Tracing and profiling helpers (port of dpot_tpu/utils/profiling.py).

- `fence`: wait for the device, then read one value of a tensor;
- `host_fetch`: CPU copies of a tree of tensors (dicts, lists, tuples),
  a sharded FSDP2 tensor gathered whole (parallel/fsdp.py `gathered`, a
  collective that every rank of its mesh calls);
- `timing`: a decorator printing a call's wall time, the current CUDA
  device synchronised before each reading of the clock;
- `profiled_function`: a `torch.profiler.record_function` range named
  after the function (the reference's torch_utils/misc.py:117-125);
- `trace(log_dir)`: a `torch.profiler.profile` of the CPU and, where CUDA
  is available, the card, exported as a Chrome trace into `log_dir`;
- `AverageMeter`, `EpochTimer` and `count_parameters` (complex parameters
  counted twice, as the reference's utilities.py:89-96 and JAX count them).

The JAX module's `maybe_enable_compilation_cache` sets XLA's persistent
compilation cache; the port compiles no programs at run time (its kernels
are built once by nvcc into build/, ops/cuda/build.py), so it has no
counterpart.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Iterable, Mapping

import torch
from torch.utils._pytree import tree_map


def _synchronize(device: torch.device | None = None) -> None:
    """Wait for the CUDA device (`device`, else the current one), where
    CUDA has been used in this process."""
    if device is not None and device.type != "cuda":
        return
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize(device)


def fence(x: torch.Tensor) -> float:
    """Wait for x's device to finish its queued work and return x's first
    element as a float."""
    _synchronize(x.device)
    return float(x.detach().reshape(-1)[0].item())


def host_fetch(tree):
    """CPU copies of the tensors of a tree (dicts, lists, tuples; other
    leaves pass through), fresh buffers even for CPU tensors, so that a
    later in-place update of the state leaves them as they were. A sharded
    FSDP2 tensor comes back whole (`gathered`): every rank of its mesh must
    call this on the same tree. A tensor-parallel shard is a rank's own
    tensor and comes back as that shard (train/state.py gathers them by
    name)."""
    from dpot_tpu_torch.parallel.fsdp import gathered

    def get(a):
        if not isinstance(a, torch.Tensor):
            return a
        return gathered(a).detach().to("cpu", copy=True)

    return tree_map(get, tree)


def timing(fn):
    """Print the wall time of each call of fn, the device synchronised
    before the clock is read at its start and its end (reference
    utils/utilities.py:78-86)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        _synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _synchronize()
        print(f"{fn.__name__} took {time.perf_counter() - t0:.6f}s")
        return out

    return wrapped


def profiled_function(fn):
    """Run fn inside a profiler range named after it."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(fn.__name__):
            return fn(*args, **kwargs)

    return wrapped


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (the CPU, and CUDA where it is available) and
    write its Chrome trace (chrome://tracing, Perfetto) into `log_dir`,
    as trace_<pid>_<time>.json; yields the profiler, whose `trace_file`
    names the file once the block has ended."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.trace_file = None
    with prof:
        yield prof
        _synchronize()  # the block's kernels end inside the profile
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    prof.trace_file = path


class AverageMeter:
    """Reference AverageMeter (utils/utilities.py)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class EpochTimer:
    """Wall-clock buckets (load / train / test) of the reference's epoch
    printout (train_temporal.py:182-183, 247-248)."""

    def __init__(self):
        self.buckets: dict[str, float] = {}
        self._t = time.perf_counter()

    def tick(self, bucket: str):
        now = time.perf_counter()
        self.buckets[bucket] = self.buckets.get(bucket, 0.0) + (now - self._t)
        self._t = now

    def get(self, bucket: str) -> float:
        return self.buckets.get(bucket, 0.0)


def count_parameters(params: torch.nn.Module | Mapping | Iterable) -> int:
    """Parameter count of a module (its parameters, not its buffers), a
    mapping of tensors or an iterable of them; a complex tensor counts
    twice."""
    if isinstance(params, torch.nn.Module):
        params = params.parameters()
    elif isinstance(params, Mapping):
        params = params.values()
    return sum(t.numel() * (2 if t.is_complex() else 1) for t in params)
