"""Normalization ops, channels-last (port of dpot_tpu/ops/norms.py).

group_norm matches torch.nn.GroupNorm(num_groups, C): statistics over
(spatial..., channels-within-group) in float32, per-channel affine, eps 1e-5.
"""

from __future__ import annotations

import torch


def group_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int,
    eps: float = 1e-5,
) -> torch.Tensor:
    """x: (B, ..., C) channels-last; scale/bias: (C,)."""
    B, C = x.shape[0], x.shape[-1]
    g = num_groups
    xg = x.float().reshape(B, -1, g, C // g)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    xn = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return (xn * scale + bias).to(x.dtype)


def instance_stats(
    x: torch.Tensor, dims: tuple[int, ...], eps: float = 1e-6, ddof: int = 1
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample mean/std over `dims` (keepdim), float32. torch's .std()
    is the unbiased estimator (ddof=1); eps is added to sigma, not to the
    variance, as the reference's reversible instance norm does."""
    x32 = x.float()
    mu = x32.mean(dim=dims, keepdim=True)
    n = 1
    for d in dims:
        n *= x.shape[d]
    var = (x32 - mu).square().sum(dim=dims, keepdim=True) / max(n - ddof, 1)
    return mu, var.sqrt() + eps
