"""Activation registry (PyTorch port of dpot_tpu/ops/activations.py).

`gelu` follows the tensor's dtype: exact (erf) under float32, which is
torch.nn.GELU's default and what checkpoint parity needs, and the tanh
approximation under bfloat16, whose error sits below bf16's resolution.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

Act = Callable[[torch.Tensor], torch.Tensor]


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")


_ACTIVATIONS: dict[str, Act] = {
    "gelu": _gelu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "relu": F.relu,
    "leaky_relu": lambda x: F.leaky_relu(x, negative_slope=0.1),
    "softplus": F.softplus,
    "ELU": F.elu,
    "elu": F.elu,
    "silu": F.silu,
}


def get_activation(name: str) -> Act:
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(
            f"unknown activation {name!r}; available: {sorted(_ACTIVATIONS)}"
        ) from None
