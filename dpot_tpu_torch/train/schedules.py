"""Per-iteration LR schedules (port of dpot_tpu/train/schedules.py).

The six schedules of the reference entry scripts, stepped per optimizer
step, plus the OneCycle beta1 trajectory. Each is a plain `step -> value`
callable over Python numbers, evaluated on the host, so a schedule never
adds a device operation or a sync to the train step.
"""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def _cos_anneal(start: float, end: float, pct: float) -> float:
    return end + (start - end) / 2.0 * (1.0 + math.cos(math.pi * pct))


def _clip01(v: float) -> float:
    return min(max(v, 0.0), 1.0)


def _onecycle_fenceposts(total_steps: int, warmup_epochs: float, epochs: float):
    pct_start = min(max(warmup_epochs / epochs, 0.0), 0.95)
    up = max(float(pct_start * total_steps) - 1.0, 1e-9)
    down = max(float(total_steps - 1) - up, 1e-9)
    return up, down


def onecycle(
    max_lr: float,
    total_steps: int,
    warmup_epochs: float,
    epochs: float,
    div_factor: float = 1e4,
    final_div_factor: float = 1e4,
) -> Schedule:
    """torch OneCycleLR with cos anneal and its fenceposts: warm-up spans
    [0, pct_start * total - 1], the anneal the rest, and the last step's lr
    is initial / final_div_factor."""
    initial = max_lr / div_factor
    min_lr = initial / final_div_factor
    up, down = _onecycle_fenceposts(total_steps, warmup_epochs, epochs)

    def schedule(count: int) -> float:
        c = float(count)
        if c <= up:
            return _cos_anneal(initial, max_lr, _clip01(c / up))
        return _cos_anneal(max_lr, min_lr, _clip01((c - up) / down))

    return schedule


def onecycle_momentum(
    total_steps: int,
    warmup_epochs: float,
    epochs: float,
    base_momentum: float = 0.85,
    max_momentum: float = 0.95,
) -> Schedule:
    """OneCycleLR's cycle_momentum beta1 trajectory: max_momentum, annealed
    to base_momentum at the peak lr and back to max_momentum at the end.
    The reference's 'cycle' runs always train with it (its optimizers read
    the group's current betas each step). Same fenceposts as onecycle."""
    up, down = _onecycle_fenceposts(total_steps, warmup_epochs, epochs)

    def schedule(count: int) -> float:
        c = float(count)
        if c <= up:
            return _cos_anneal(max_momentum, base_momentum, _clip01(c / up))
        return _cos_anneal(base_momentum, max_momentum, _clip01((c - up) / down))

    return schedule


def step_decay(base_lr: float, step_size: int, gamma: float = 0.5) -> Schedule:
    """torch StepLR stepped per iteration."""
    return lambda count: base_lr * gamma ** math.floor(count / step_size)


def warmup_inv_sqrt(base_lr: float, warmup_steps: int) -> Schedule:
    """LambdaLR(min((s+1)/warmup, sqrt(warmup/(s+1))))."""

    def schedule(count: int) -> float:
        s = float(count) + 1.0
        return base_lr * min(s / warmup_steps, math.sqrt(warmup_steps / s))

    return schedule


def linear_decay(base_lr: float, total_steps: int) -> Schedule:
    """LambdaLR(1 - s/total)."""
    return lambda count: base_lr * (1.0 - float(count) / total_steps)


def cosine_restarts(base_lr: float, t0_steps: int) -> Schedule:
    """CosineAnnealingWarmRestarts(T_0, eta_min=0)."""
    return lambda count: base_lr * 0.5 * (
        1.0 + math.cos(math.pi * (float(count) % t0_steps) / t0_steps)
    )


def cyclic_triangular2(
    base_lr: float = 1e-5, max_lr: float = 1e-3, step_size_up: int = 1000
) -> Schedule:
    """CyclicLR(mode='triangular2')."""

    def schedule(count: int) -> float:
        c = float(count)
        cycle = math.floor(1.0 + c / (2.0 * step_size_up))
        x = abs(c / step_size_up - 2.0 * cycle + 1.0)
        return base_lr + (max_lr - base_lr) * max(0.0, 1.0 - x) / 2.0 ** (cycle - 1.0)

    return schedule


def build_schedule(
    method: str,
    lr: float,
    steps_per_epoch: int,
    epochs: int,
    warmup_epochs: float = 5,
    step_size: int = 100,
    step_gamma: float = 0.5,
    lr_step_size: int = 20,
) -> Schedule:
    """Schedule by the reference's --lr_method name."""
    total = steps_per_epoch * epochs
    if method == "cycle":
        return onecycle(lr, total, warmup_epochs, epochs)
    if method == "step":
        return step_decay(lr, step_size * steps_per_epoch, step_gamma)
    if method == "warmup":
        return warmup_inv_sqrt(lr, warmup_epochs * steps_per_epoch)
    if method == "linear":
        return linear_decay(lr, total)
    if method == "restart":
        return cosine_restarts(lr, lr_step_size * steps_per_epoch)
    if method == "cyclic":
        return cyclic_triangular2(step_size_up=lr_step_size * steps_per_epoch)
    raise ValueError(f"unknown lr schedule {method!r}")
