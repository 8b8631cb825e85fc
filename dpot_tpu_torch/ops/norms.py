"""Normalization ops, channels-last (port of dpot_tpu/ops/norms.py).

group_norm matches torch.nn.GroupNorm(num_groups, C): statistics over
(spatial..., channels-within-group) in float32, per-channel affine, eps 1e-5.

Both take `axis`, the 'spatial' axis of a mesh (parallel/mesh.py) when x is
this rank's rows of a latent split over it: the sums behind the statistics
are then summed over the axis's ranks (`all_sum`), so every rank normalizes
its rows with the whole latent's statistics.
"""

from __future__ import annotations

import torch


def group_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int,
    eps: float = 1e-5,
    axis=None,
) -> torch.Tensor:
    """x: (B, ..., C) channels-last; scale/bias: (C,)."""
    B, C = x.shape[0], x.shape[-1]
    g = num_groups
    xg = x.float().reshape(B, -1, g, C // g)
    if axis is None:
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    else:
        from dpot_tpu_torch.parallel.mesh import all_sum

        n = xg.shape[1] * xg.shape[3] * axis.size
        mean = all_sum(xg.sum(dim=(1, 3), keepdim=True), axis) / n
        var = all_sum((xg - mean).square().sum(dim=(1, 3), keepdim=True), axis) / n
    xn = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return (xn * scale + bias).to(x.dtype)


def instance_stats(
    x: torch.Tensor, dims: tuple[int, ...], eps: float = 1e-6, ddof: int = 1,
    axis=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample mean/std over `dims` (keepdim), float32. torch's .std()
    is the unbiased estimator (ddof=1); eps is added to sigma, not to the
    variance, as the reference's reversible instance norm does."""
    x32 = x.float()
    n = 1
    for d in dims:
        n *= x.shape[d]
    if axis is None:
        mu = x32.mean(dim=dims, keepdim=True)
        var = (x32 - mu).square().sum(dim=dims, keepdim=True) / max(n - ddof, 1)
    else:
        from dpot_tpu_torch.parallel.mesh import all_sum

        n *= axis.size
        mu = all_sum(x32.sum(dim=dims, keepdim=True), axis) / n
        var = all_sum((x32 - mu).square().sum(dim=dims, keepdim=True), axis) / max(n - ddof, 1)
    return mu, var.sqrt() + eps
