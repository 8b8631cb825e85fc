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
`torch._foreach_*` pass over the parameter list per quantity. The DPOT
parameters are real, so the JAX package's complex-safe second moment
|g|^2 is g^2 here. A parameter without a gradient (the classifier head,
whose loss is not trained) is updated with a zero gradient, as JAX's
dense gradient tree gives it.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional, Sequence, Union

import torch

Schedule = Union[float, Callable[[int], float]]


def _at(v: Schedule, count: int) -> float:
    return float(v(count)) if callable(v) else float(v)


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

    def lr_at(self, count: int) -> float:
        return _at(self.learning_rate, count)

    @torch.no_grad()
    def step(self, grads: Optional[Sequence[Optional[torch.Tensor]]] = None) -> None:
        """One update from `grads`, one per parameter, by default the
        parameters' .grad. None counts as zero; a bf16 gradient (from a
        working copy, train/state.py) is upcast for all the arithmetic."""
        params = self.params
        if grads is None:
            grads = [p.grad for p in params]
        grads = [(g if g is not None else torch.zeros_like(p)).float()
                 for g, p in zip(grads, params, strict=True)]
        count = self.count + 1
        b1c = _at(self.b1, self.count)
        lr = self.lr_at(self.count)
        b2, eps, wd = self.b2, self.eps, self.weight_decay

        gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        # out of place: the parameters' .grad stay as the backward left them
        if self.clip_norm is not None:
            cs = torch.clamp(self.clip_norm / (gnorm + 1e-6), max=1.0)
            grads = torch._foreach_mul(grads, cs)
        if self.rule == "adam" and wd != 0.0:
            grads = torch._foreach_add(grads, params, alpha=wd)  # coupled decay

        # moments: accumulate in f32, store in the moment's dtype
        mu32 = [m if m.dtype == torch.float32 else m.float() for m in self.mu]
        torch._foreach_mul_(mu32, b1c)
        torch._foreach_add_(mu32, grads, alpha=1.0 - b1c)
        for m, a in zip(self.mu, mu32):
            if m is not a:
                m.copy_(a)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        mu_p = [m.to(p.dtype) for m, p in zip(self.mu, params)]

        denom = torch._foreach_sqrt(self.nu)
        if self.rule == "lamb":
            torch._foreach_add_(denom, eps)
            upd = torch._foreach_div(mu_p, denom)
            if wd != 0.0:
                torch._foreach_add_(upd, params, alpha=wd)
            torch._foreach_add_(params, upd, alpha=-lr)
        else:
            bc1 = 1.0 - b1c ** count
            bc2 = 1.0 - b2 ** count
            torch._foreach_div_(denom, math.sqrt(bc2))
            torch._foreach_add_(denom, eps)
            upd = torch._foreach_div(mu_p, denom)
            torch._foreach_mul_(upd, -lr / bc1)
            if self.rule == "adamw":
                torch._foreach_add_(upd, params, alpha=-lr * wd)
            torch._foreach_add_(params, upd)
        self.count = count
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
            dst.copy_(src)
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
