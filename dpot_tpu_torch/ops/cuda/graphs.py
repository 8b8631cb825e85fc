"""CUDA graphs over the port's kernels: one dispatch for a train step, K of
them, or a whole rollout (the counterpart of JAX's jitted `lax.scan`).

`Graph(fn)` captures everything `fn()` enqueues on the card into one
`torch.cuda.CUDAGraph`; `replay()` runs it again on the same buffers and
returns the same output tensors, refreshed. The caller owns the buffers:
it copies new inputs into the ones `fn` read and copies the outputs out
before the next replay.

Capture records work and runs none, while the wrappers count launches in
Python. So a capture takes back what its launches added to
`fused_gn_afno.launches`, `fused_gn_afno.launches_by_path`,
`bias_act.launches` and `separable_gn_afno.calls` (the separable route's
calls), and every replay adds them again: the counts stay the number of
kernels (and routes) that ran.

The hazards of capture, and what the port does about each:
- cuFFT plans (the 3D mixer, the separable 2D route) live in torch's plan
  cache, keyed on the transform's shapes: the warm-up makes them, and the
  capture finds them there;
- a host-to-device copy during capture is illegal: the cached device
  constants (`ops/spectral.py` `combined_spectral_ops`, `models/dpot.py`
  `grid_patches`) raise on a miss under capture, so every capture site runs
  the same function eagerly first (its warm-up), which fills them; those
  caches never evict, because a graph reads their tensors by address;
- a decision taken on the host is frozen into the graph: the bf16 weight
  copies of `fused_gn_afno` are made inside every capture, never taken from
  their cache (`ops/cuda/afno_fused.py` `_bf16_blocks`); the optimizer
  reads its per-step scalars from a device buffer (`train/optimizers.py`);
- a replay changes tensors behind autograd's back: `mutated` tensors get
  their version counters bumped after every replay, so that a cache keyed
  on the version (the bf16 weight copies) sees the change;
- a generator's draws: `generators` are registered with the graph, so that
  replay i draws what the i-th eager call would.
Every failure raises; nothing falls back to eager work.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Iterable, Sequence

import torch


def capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def _counts() -> dict[str, int]:
    from dpot_tpu_torch.ops.cuda.afno_fused import fused_gn_afno
    from dpot_tpu_torch.ops.cuda.bias_act import bias_act
    from dpot_tpu_torch.ops.spectral import separable_gn_afno

    return {"fused_gn_afno": fused_gn_afno.launches, "bias_act": bias_act.launches,
            "separable": separable_gn_afno.calls,
            **{f"path/{p}": n for p, n in fused_gn_afno.launches_by_path.items()}}


def _add(delta: dict[str, int]) -> None:
    from dpot_tpu_torch.ops.cuda.afno_fused import fused_gn_afno
    from dpot_tpu_torch.ops.cuda.bias_act import bias_act
    from dpot_tpu_torch.ops.spectral import separable_gn_afno

    fused_gn_afno.launches += delta["fused_gn_afno"]
    bias_act.launches += delta["bias_act"]
    separable_gn_afno.calls += delta["separable"]
    for p in fused_gn_afno.launches_by_path:
        fused_gn_afno.launches_by_path[p] += delta[f"path/{p}"]


@contextlib.contextmanager
def side_stream():
    """Run the body on a fresh stream that follows the current one, and let
    the current stream wait for it: where a capture's warm-up runs."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        yield
    torch.cuda.current_stream().wait_stream(s)


class Graph:
    """`fn()` captured once as a CUDA graph.

    pool: a `torch.cuda.graph_pool_handle()` shared with other graphs that
    are replayed one at a time on one stream; generators: CUDA generators
    that `fn` draws from; mutated: tensors that `fn` updates in place. The
    capture is `thread_local`: other threads may use the card meanwhile."""

    def __init__(self, fn: Callable[[], Any], pool=None,
                 generators: Sequence[torch.Generator] = (),
                 mutated: Iterable[torch.Tensor] = ()):
        self.graph = torch.cuda.CUDAGraph()
        for g in generators:
            self.graph.register_generator_state(g)
        before = _counts()
        try:
            with torch.cuda.graph(self.graph, pool=pool, capture_error_mode="thread_local"):
                self.outputs = fn()
        finally:
            after = _counts()
            _add({k: before[k] - after[k] for k in before})
        self.launches = {k: after[k] - before[k] for k in before}
        self.mutated = list(mutated)

    def replay(self) -> Any:
        self.graph.replay()
        _add(self.launches)
        if self.mutated:
            torch.autograd.graph.increment_version(self.mutated)
        return self.outputs


class GraphCache:
    """Graphs of one function of named tensors, one per key and input
    shapes, sharing one memory pool: for functions whose graphs replay one
    at a time on one stream, each replay's outputs copied out by the caller
    before the next. The first call of a key runs the function eagerly (the
    capture's warm-up; its result is the call's), then captures it over
    copies of the inputs; later calls copy their inputs in and replay.
    `captures` counts the graphs made."""

    def __init__(self):
        self._graphs: dict = {}
        self._pool = None
        self.captures = 0

    def __call__(self, fn: Callable[[dict], Any], inputs: dict[str, torch.Tensor],
                 key: tuple = ()) -> Any:
        full_key = (key, signature(inputs))
        entry = self._graphs.get(full_key)
        if entry is not None:
            static, graph = entry
            copy_into(static, inputs)
            return graph.replay()
        out = fn(inputs)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        static = {k: v.clone() for k, v in inputs.items()}
        self._graphs[full_key] = (static, Graph(lambda: fn(static), pool=self._pool))
        self.captures += 1
        return out


def copy_into(dst: dict[str, torch.Tensor], src: dict[str, torch.Tensor]) -> None:
    """Copy each tensor of `src` into the static buffer of its name, which
    must have its shape and dtype."""
    if dst.keys() != src.keys():
        raise ValueError(f"inputs {sorted(src)} do not match the graph's {sorted(dst)}")
    for k, t in src.items():
        dst[k].copy_(t)


def signature(tensors: dict[str, torch.Tensor]) -> tuple:
    """The shapes and dtypes of named tensors: the key of a graph cache."""
    return tuple((k, tuple(t.shape), t.dtype) for k, t in sorted(tensors.items()))
