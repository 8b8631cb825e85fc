"""Fused bias + activation + gain + clamp (port of dpot_tpu/ops/bias_act.py).

The reference plugin's 9-activation table with its default alpha and gain,
`bias_act_ref` (the composition in torch ops, differentiable to any order)
and `bias_act`, which runs the hand-written CUDA kernel
(ops/cuda/bias_act.py, csrc/bias_act.cu) for a CUDA tensor and
`bias_act_ref` for a CPU tensor. There is no fallback from the kernel to
the composition: a CUDA call launches the kernel or raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ActSpec:
    func: Callable
    def_alpha: float
    def_gain: float


activation_funcs: dict[str, ActSpec] = {
    "linear": ActSpec(lambda x, alpha: x, 0.0, 1.0),
    "relu": ActSpec(lambda x, alpha: F.relu(x), 0.0, math.sqrt(2)),
    # jax.nn.leaky_relu: where(x >= 0, x, alpha * x)
    "lrelu": ActSpec(lambda x, alpha: torch.where(x >= 0, x, alpha * x), 0.2, math.sqrt(2)),
    "tanh": ActSpec(lambda x, alpha: torch.tanh(x), 0.0, 1.0),
    "sigmoid": ActSpec(lambda x, alpha: torch.sigmoid(x), 0.0, 1.0),
    "elu": ActSpec(lambda x, alpha: F.elu(x), 0.0, 1.0),
    "selu": ActSpec(lambda x, alpha: F.selu(x), 0.0, 1.0),
    # log(1 + e^x) without torch's threshold switch, as jax.nn.softplus
    "softplus": ActSpec(lambda x, alpha: torch.logaddexp(x, torch.zeros_like(x)), 0.0, 1.0),
    "swish": ActSpec(lambda x, alpha: F.silu(x), 0.0, math.sqrt(2)),
}


def resolve(act: str, alpha, gain, clamp) -> tuple[ActSpec, float, float, float]:
    """(spec, alpha, gain, clamp) with the activation's defaults filled in;
    clamp -1 means no clamp."""
    if act not in activation_funcs:
        raise ValueError(f"unknown activation {act!r}; available: {sorted(activation_funcs)}")
    spec = activation_funcs[act]
    alpha = float(alpha if alpha is not None else spec.def_alpha)
    gain = float(gain if gain is not None else spec.def_gain)
    clamp = float(clamp if clamp is not None else -1.0)
    if not (clamp >= 0 or clamp == -1.0):
        raise ValueError(f"clamp must be >= 0 or None, got {clamp}")
    return spec, alpha, gain, clamp


def bias_act_ref(
    x: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    dim: int = -1,
    act: str = "linear",
    alpha=None,
    gain=None,
    clamp=None,
) -> torch.Tensor:
    """The composition: x + b along `dim` -> activation -> x gain -> clamp.
    The result has the promoted dtype of x and b."""
    spec, alpha, gain, clamp = resolve(act, alpha, gain, clamp)
    if b is not None:
        shape = [1] * x.dim()
        shape[dim % x.dim()] = -1
        x = x + b.reshape(shape)
    x = spec.func(x, alpha)
    if gain != 1.0:
        x = x * gain
    if clamp >= 0:
        x = torch.clamp(x, -clamp, clamp)
    return x


def bias_act(
    x: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    dim: int = -1,
    act: str = "linear",
    alpha=None,
    gain=None,
    clamp=None,
) -> torch.Tensor:
    """Fused bias + activation + gain + clamp: the CUDA kernel for a CUDA
    tensor, the composition for a CPU tensor, differentiable to any order
    on both. The kernel is channels-last; another `dim` is moved last and
    back."""
    from dpot_tpu_torch.ops.cuda.bias_act import bias_act as channels_last

    if x.dim() == 0:
        raise ValueError("bias_act needs at least one dimension")
    d = dim % x.dim()
    if d == x.dim() - 1:
        return channels_last(x, b, act, alpha, gain, clamp)
    y = channels_last(x.movedim(d, -1).contiguous(), b, act, alpha, gain, clamp)
    return y.movedim(-1, d)
