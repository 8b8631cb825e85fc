"""Anti-aliased resampling and filtered activations, the CNO components
(port of dpot_tpu/ops/resample.py), channels-last.

`lrelu_filtered` is the reference's LReLu_torch (bilinear antialiased
upsample x2 -> LeakyReLU -> downsample -> optional resize to out_size ->
+ bias), `lrelu_regular` its LReLu_regular, and `low_pass_filter`
CNOBlock.filter_frequency with its quirk of keeping only the non-negative
frequency corner [:H//K, :H//K] of the full spectrum.

`resize_bilinear` is torch's antialiased bilinear interpolation (half-pixel
centres, the triangle filter widened on downsampling), which equals
jax.image.resize(method="linear", antialias=True) at every ratio from 1..39
to 1..69 pixels (f32, 1e-5; tests/test_torch_resample.py holds the ratios
CDPOT reaches). It computes in float32 whatever x's dtype, since the CPU
kernel takes no bfloat16, and rounds the result to x's dtype once.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dpot_tpu_torch.ops.spectral import fft2_pair, ifft2_pair


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int],
                    antialias: bool = True) -> torch.Tensor:
    """Bilinear resize of (..., H, W, C) over (H, W) to out_hw."""
    *lead, H, W, C = x.shape
    y = F.interpolate(x.float().reshape(-1, H, W, C).permute(0, 3, 1, 2), size=tuple(out_hw),
                      mode="bilinear", antialias=antialias, align_corners=False)
    return y.permute(0, 2, 3, 1).reshape(*lead, *out_hw, C).to(x.dtype)


def lrelu_filtered(x: torch.Tensor, bias: torch.Tensor, in_size: int,
                   out_size: int | None = None,
                   negative_slope: float = 0.01) -> torch.Tensor:
    """LReLu_torch on (B, H, W, C): upsample x2, LeakyReLU, downsample
    (antialiased), resize to out_size when it differs, add the per-channel
    bias (whose float32 promotes a bfloat16 x, as in JAX)."""
    out_size = out_size if out_size is not None else in_size
    x = resize_bilinear(x, (2 * in_size, 2 * in_size))
    x = F.leaky_relu(x, negative_slope)
    x = resize_bilinear(x, (in_size, in_size))
    if in_size != out_size:
        x = resize_bilinear(x, (out_size, out_size))
    return x + bias


def lrelu_regular(x: torch.Tensor, in_rate: int, out_rate: int, out_size: int,
                  negative_slope: float = 0.01) -> torch.Tensor:
    """LReLu_regular on (B, H, W, C): LeakyReLU, then a 2x2 average pool
    (in_rate = 2 out_rate), a 4x4 one over the zero-padded field (4x), or
    else the reference's nearest interpolation (src = floor(dst * in / out))."""
    x = F.leaky_relu(x, negative_slope)
    if in_rate == 2 * out_rate:
        return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    if in_rate == 4 * out_rate:
        xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1))
        return F.avg_pool2d(xp, 4).permute(0, 2, 3, 1)
    H, W = x.shape[1], x.shape[2]
    ih = (torch.arange(out_size, device=x.device) * (H / out_size)).long()
    iw = (torch.arange(out_size, device=x.device) * (W / out_size)).long()
    return x[:, ih][:, :, iw]


def low_pass_filter(x: torch.Tensor, K: int) -> torch.Tensor:
    """CNOBlock.filter_frequency on (B, H, W, C): the full 2D FFT over
    (H, W) in float32, everything outside [:H//K, :H//K] zeroed, the inverse
    FFT's real part in x's dtype. K = 1 keeps the whole spectrum: x itself."""
    H = x.shape[1]
    cutoff = H // K
    if cutoff >= H:
        return x
    re, im = fft2_pair(x.float(), dims=(1, 2))
    mask = torch.zeros(re.shape[1:3], device=x.device)
    mask[:cutoff, :cutoff] = 1.0
    mask = mask[:, :, None]
    yr, _ = ifft2_pair(re * mask, im * mask, dims=(1, 2))
    return yr.to(x.dtype)
