"""Initializers matching the reference's (PyTorch-default) distributions,
drawn from an explicit torch.Generator (port of dpot_tpu/ops/initializers.py).

Each function fills and returns a float32 tensor of `shape`. Linear and
conv layers use U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias;
AFNO weights use scale * U[0, 1) with scale = 1/(block_size^2 * factor);
the time aggregator uses a scaled normal and a geometric gamma; the
position embedding a truncated normal whose cutoffs are absolute values.
"""

from __future__ import annotations

import math

import torch


def torch_uniform(shape, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)), torch Linear/Conv default."""
    bound = 1.0 / math.sqrt(fan_in)
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


def scaled_uniform(shape, scale: float, generator: torch.Generator) -> torch.Tensor:
    """scale * U[0, 1): the AFNO spectral-MLP init."""
    return scale * torch.rand(shape, generator=generator)


def scaled_normal(shape, scale: float, generator: torch.Generator) -> torch.Tensor:
    return scale * torch.randn(shape, generator=generator)


def trunc_normal(
    shape, generator: torch.Generator, std: float = 0.02, a: float = -2.0,
    b: float = 2.0,
) -> torch.Tensor:
    """torch.nn.init.trunc_normal_ semantics: a/b are ABSOLUTE cutoffs,
    not multiples of std (at std 0.02 the +-2 window is +-100 sigma).
    Inverse-CDF sampling, as torch does it."""

    def cdf(v):
        return 0.5 * (1.0 + math.erf(v / math.sqrt(2.0)))

    lo, hi = cdf(a / std), cdf(b / std)
    u = torch.empty(shape).uniform_(2 * lo - 1, 2 * hi - 1, generator=generator)
    return (torch.erfinv(u) * (std * math.sqrt(2.0))).clamp_(a, b)


def gamma_geometric(channels: int) -> torch.Tensor:
    """TimeAggregator gamma: 2**linspace(-10, 10, C), shape (1, C)."""
    return (2.0 ** torch.linspace(-10.0, 10.0, channels)).reshape(1, channels)
