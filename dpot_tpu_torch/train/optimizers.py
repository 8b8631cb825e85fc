"""The reference's optimizers, as the JAX package defines them (port of
dpot_tpu/train/optimizers.py; not torch.optim).

- `adam`: coupled weight decay (added to the gradient), bias-corrected;
- `adamw`: decoupled decay p -= lr * wd * p, folded into the update;
- `lamb`: the configuration the training scripts run (adam mode, no
  debiasing, trust ratio 1): p -= lr * (m / (sqrt(v) + eps) + wd * p).

Common to all three:
- `lr` and `b1` may be schedules (`step -> value`); both are read at the
  count before the update, and b1's current value also enters the bias
  correction, as OneCycleLR's cycled beta1 does in the reference;
- the global-norm clip is fused into the update: the gradient is scaled by
  min(1, clip / (|g| + 1e-6)), and the pre-clip norm |g| is kept as
  `grad_norm` (a device tensor, so reading it is the caller's choice of
  sync);
- the first moment may be stored in bf16 (`moment_dtype`) while every
  accumulation runs in f32; the second moment always stays f32, because
  b2 = 0.999's decay is below bf16's resolution near 1.

Parameters are updated in place under `torch.no_grad()`, one
`torch._foreach_*` pass over the parameter list per quantity. What changes
from step to step (b1 and its complement, the step size lr / bc1 or lr,
1 / sqrt(bc2), adamw's decay lr * wd) is computed on the host from the
schedules, in float64, and reaches the update as a row of `N_VALUES` f32
device scalars (`values_at`, `step(values=...)`): a CUDA graph replays the
same arithmetic with the rows of its dispatch (train/step.py), and the
eager step takes the same route, so the two compute the same update. Each
x + s * y with such a scalar is one fused multiply-add
(`_foreach_addcmul_` over broadcast views of s), the rounding of
`_foreach_add_(x, y, alpha=s)` with a host float: the update is the one a
host-float optimizer computes, bit for bit on the H100. The DPOT
parameters are real, so the JAX package's complex-safe second moment
|g|^2 is g^2 here. A parameter without a gradient (the classifier head,
whose loss is not trained) is updated with a zero gradient, as JAX's
dense gradient tree gives it.

Under FSDP2 (parallel/fsdp.py) the parameters, their gradients and the
moments are DTensor shards: the same arithmetic runs on each rank's local
shards, and the global norm is the square root of the shards' squared
norms summed over the ranks by one all-reduce. Tensor and pipeline
parallelism (parallel/tensor.py, parallel/pipeline.py) hold some
parameters as shards (a TP slice, a stage's blocks) and set
`shard_groups`: per parameter, the process groups over which its shards
are spread, so that the squared norms of the shards are summed over those
groups and a leaf that every rank holds whole is counted once. One process
takes the unsharded route, bit for bit as before.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from dpot_tpu_torch.parallel.fsdp import shard_like

Schedule = Union[float, Callable[[int], float]]

# the per-step scalars of one update (Optimizer.step_values)
N_VALUES = 5


def _at(v: Schedule, count: int) -> float:
    return float(v(count)) if callable(v) else float(v)


def _local(ts: Sequence[Optional[torch.Tensor]]) -> list[Optional[torch.Tensor]]:
    """This rank's shards of DTensors (views: an in-place update of one
    updates the DTensor); other entries as they are."""
    return [t.to_local() if isinstance(t, DTensor) else t for t in ts]


def _sharded_norm(grads: list[torch.Tensor], groups: list[tuple]) -> torch.Tensor:
    """The global norm of gradients some of which are shards: the squared
    norms summed per set of groups (in the order of first appearance, the
    same on every rank), each sum all-reduced over its groups, the sums
    added."""
    sq = torch.stack(torch._foreach_norm(grads)).square()
    buckets: dict[tuple, list[int]] = {}
    for i, g in enumerate(groups):
        buckets.setdefault(tuple(id(x) for x in g), []).append(i)
    total = sq.new_zeros(())
    for idx in buckets.values():
        part = sq[idx].sum()
        for group in groups[idx[0]]:
            dist.all_reduce(part, group=group)
        total = total + part
    return total.sqrt()


def _broadcast(s: torch.Tensor, like: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """A 0-dim tensor as a view of each shape of `like`: x + s * y as
    `_foreach_addcmul_(x, y, _broadcast(s, y))` rounds once, as
    `_foreach_add_(x, y, alpha=s)` does with a host float."""
    return [s.expand_as(t) for t in like]


class Optimizer:
    """Moments, count and update rule of one of the three optimizers over a
    fixed list of parameters."""

    def __init__(
        self,
        params: Iterable[torch.Tensor],
        rule: str,
        learning_rate: Schedule,
        b1: Schedule,
        b2: float,
        eps: float,
        weight_decay: float,
        clip_norm: Optional[float] = None,
        moment_dtype: Optional[torch.dtype] = None,
    ):
        if rule not in ("adam", "adamw", "lamb"):
            raise ValueError(f"unknown optimizer {rule!r}")
        self.params = list(params)
        self.rule = rule
        self.learning_rate = learning_rate
        self.b1 = b1
        self.b2 = b2
        self.eps = eps
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.count = 0
        self.mu = [torch.zeros_like(p, dtype=moment_dtype or p.dtype) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        device = self.params[0].device if self.params else None
        self.grad_norm = torch.zeros((), device=device)
        # per parameter, the process groups its shards are spread over
        # (parallel/tensor.py, parallel/pipeline.py); None: none is a shard
        self.shard_groups: Optional[list[tuple]] = None

    def lr_at(self, count: int) -> float:
        return _at(self.learning_rate, count)

    def step_values(self, count: int) -> list[float]:
        """The update's per-step scalars at `count` (the count before the
        update), in float64: b1, 1 - b1, the step size (-lr / bc1, or -lr
        for lamb), 1 / sqrt(bc2) (1 for lamb) and adamw's decay -lr * wd.
        The reciprocal is taken here because a division by a host float
        multiplies by its reciprocal, so the update rounds as it would."""
        b1c = _at(self.b1, count)
        lr = self.lr_at(count)
        if self.rule == "lamb":
            return [b1c, 1.0 - b1c, -lr, 1.0, 0.0]
        n = count + 1
        bc1 = 1.0 - b1c ** n
        return [b1c, 1.0 - b1c, -lr / bc1, 1.0 / math.sqrt(1.0 - self.b2 ** n),
                -lr * self.weight_decay]

    def values_at(self, counts: Sequence[int]) -> torch.Tensor:
        """`step_values` of each count, as a (len(counts), N_VALUES) f32
        tensor on the parameters' device (through pinned memory, without
        waiting for the card)."""
        t = torch.tensor([self.step_values(c) for c in counts], dtype=torch.float32)
        device = self.grad_norm.device
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t

    @torch.no_grad()
    def step(self, grads: Optional[Sequence[Optional[torch.Tensor]]] = None,
             values: Optional[torch.Tensor] = None) -> None:
        """One update from `grads`, one per parameter, by default the
        parameters' .grad. None counts as zero; a bf16 gradient (from a
        working copy, train/state.py) is upcast for all the arithmetic.
        values: this update's row of `values_at` (N_VALUES,) on the
        parameters' device, by default made for the current count."""
        params = self.params
        if grads is None:
            grads = [p.grad for p in params]
        sharded = any(isinstance(p, DTensor) for p in params)
        if sharded:  # FSDP2: the update runs on this rank's shards
            params, grads = _local(params), _local(grads)
            mus, nus = _local(self.mu), _local(self.nu)
        else:
            mus, nus = self.mu, self.nu
        grads = [(g if g is not None else torch.zeros_like(p)).float()
                 for g, p in zip(grads, params, strict=True)]
        if values is None:
            values = self.values_at([self.count])[0]
        b1c, b1c_rest, step_size, inv_sqrt_bc2, decay = values.unbind()
        b2, eps, wd = self.b2, self.eps, self.weight_decay

        groups = self.shard_groups or [()] * len(params)
        if sharded:
            groups = [g + ((p.device_mesh.get_group(),) if isinstance(p, DTensor) else ())
                      for g, p in zip(groups, self.params)]
        if any(groups):
            gnorm = _sharded_norm(grads, groups)
        else:
            gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        # out of place: the parameters' .grad stay as the backward left them
        if self.clip_norm is not None:
            cs = torch.clamp(self.clip_norm / (gnorm + 1e-6), max=1.0)
            grads = torch._foreach_mul(grads, cs)
        if self.rule == "adam" and wd != 0.0:
            grads = torch._foreach_add(grads, params, alpha=wd)  # coupled decay

        # moments: accumulate in f32, store in the moment's dtype
        mu32 = [m if m.dtype == torch.float32 else m.float() for m in mus]
        torch._foreach_mul_(mu32, b1c)
        torch._foreach_addcmul_(mu32, grads, _broadcast(b1c_rest, grads))
        for m, a in zip(mus, mu32):
            if m is not a:
                m.copy_(a)
        torch._foreach_mul_(nus, b2)
        torch._foreach_addcmul_(nus, grads, grads, value=1.0 - b2)
        mu_p = [m.to(p.dtype) for m, p in zip(mus, params)]

        denom = torch._foreach_sqrt(nus)
        if self.rule == "lamb":
            torch._foreach_add_(denom, eps)
            upd = torch._foreach_div(mu_p, denom)
            if wd != 0.0:
                torch._foreach_add_(upd, params, alpha=wd)
            torch._foreach_addcmul_(params, upd, _broadcast(step_size, upd))
        else:
            torch._foreach_mul_(denom, inv_sqrt_bc2)
            torch._foreach_add_(denom, eps)
            upd = torch._foreach_div(mu_p, denom)
            torch._foreach_mul_(upd, step_size)
            if self.rule == "adamw":
                torch._foreach_addcmul_(upd, params, _broadcast(decay, params))
            torch._foreach_add_(params, upd)
        self.count += 1
        self.grad_norm = gnorm

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": list(self.mu), "nu": list(self.nu),
                "grad_norm": self.grad_norm}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        if len(sd["mu"]) != len(self.mu) or len(sd["nu"]) != len(self.nu):
            raise ValueError("optimizer state does not match the parameter list")
        for dst, src in zip(self.mu + self.nu, list(sd["mu"]) + list(sd["nu"])):
            if dst.shape != src.shape or dst.dtype != src.dtype:
                raise ValueError(
                    f"moment {tuple(src.shape)} {src.dtype} does not match "
                    f"{tuple(dst.shape)} {dst.dtype}"
                )
            dst.copy_(shard_like(src, dst) if isinstance(dst, DTensor) else src)
        self.count = int(sd["count"])
        self.grad_norm = sd["grad_norm"].to(self.grad_norm.device)


def adam(params, learning_rate: Schedule, b1: Schedule = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 1e-6,
         clip_norm: Optional[float] = None,
         moment_dtype: Optional[torch.dtype] = None) -> Optimizer:
    """Reference Adam: coupled weight decay, bias-corrected."""
    return Optimizer(params, "adam", learning_rate, b1, b2, eps, weight_decay,
                     clip_norm, moment_dtype)


def adamw(params, learning_rate: Schedule, b1: Schedule = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-2,
          clip_norm: Optional[float] = None,
          moment_dtype: Optional[torch.dtype] = None) -> Optimizer:
    """Reference AdamW: decoupled decay p *= (1 - lr * wd), bias-corrected."""
    return Optimizer(params, "adamw", learning_rate, b1, b2, eps, weight_decay,
                     clip_norm, moment_dtype)


def lamb(params, learning_rate: Schedule, b1: Schedule = 0.9, b2: float = 0.999,
         eps: float = 1e-6, weight_decay: float = 1e-4,
         clip_norm: Optional[float] = None,
         moment_dtype: Optional[torch.dtype] = None) -> Optimizer:
    """Reference Lamb as the training scripts run it (adam mode, no
    debiasing): no bias correction, eps added to sqrt(v), trust ratio 1."""
    return Optimizer(params, "lamb", learning_rate, b1, b2, eps, weight_decay,
                     clip_norm, moment_dtype)


def build_optimizer(
    name: str,
    params,
    learning_rate: Schedule,
    beta1: Schedule = 0.9,
    beta2: float = 0.999,
    grad_clip: Optional[float] = None,
    weight_decay: Optional[float] = None,
    moment_dtype: Optional[torch.dtype] = None,
) -> Optimizer:
    """Optimizer by the reference's --opt name, with its default weight
    decay (adam 1e-6, adamw 1e-2, lamb 1e-4) unless one is given."""
    defaults = {"adam": (adam, 1e-6), "adamw": (adamw, 1e-2), "lamb": (lamb, 1e-4)}
    if name not in defaults:
        raise ValueError(f"unknown optimizer {name!r}")
    fn, wd = defaults[name]
    return fn(params, learning_rate, beta1, beta2,
              weight_decay=wd if weight_decay is None else weight_decay,
              clip_norm=grad_clip, moment_dtype=moment_dtype)
