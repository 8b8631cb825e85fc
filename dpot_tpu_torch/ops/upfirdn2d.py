"""upfirdn2d: upsample, FIR filter, downsample (port of
dpot_tpu/ops/upfirdn2d.py), and `filtered_lrelu`, the one caller of the
fused bias + activation kernel.

Layout is channels-last (B, H, W, C), as in the JAX package. The JAX
package lowers the zero-insert -> pad/crop -> FIR -> stride pipeline to one
XLA `conv_general_dilated`, outside any Pallas kernel; here it is the
reference plugin's composition (torch_utils/ops/upfirdn2d.py
_upfirdn2d_ref) on a channels-first view: zeros appended after each
sample (H * up rows), the padding (negative entries crop), then a
depthwise `F.conv2d(groups=C)` with the stride `down`; the result is the
channels-last view of that channels-first tensor. (filtered_lrelu's plain
composition at (8, 64, 64, 512), f32, 12-tap filters, took 5.3 ms with
these passes and 14.5 ms with the same passes in torch's channels_last
format: chip_smoke.py's filtered_lrelu check, NVIDIA H100 80GB HBM3,
700 W.) XLA's lhs dilation inserts the zeros between
samples ((H - 1) * up + 1 rows) and folds the missing up - 1 trailing
zeros into the after-padding, so both give the same rows.
`F.conv2d` is a correlation, as XLA's convolution is: the filter is
flipped unless `flip_filter` is set. A separable (1D) filter takes two
passes, vertical then horizontal, as in JAX.

`filtered_lrelu` runs upfirdn2d(up) -> `ops/bias_act.py` bias_act (lrelu,
gain, clamp) -> upfirdn2d(down). Its middle step is the hand-written
kernel (`csrc/bias_act.cu`) for a CUDA tensor, one launch a call, and the
plain composition for a CPU tensor; it stays differentiable (the kernel's
autograd.Function differentiates the composition). With no bias the step
is elementwise, so it runs on the up pass's channels-first tensor as it
lies in memory, and neither it nor the down pass transposes its input.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

Filt = Union[None, Sequence[float], np.ndarray, torch.Tensor]


def _parse_scaling(scaling) -> tuple[int, int]:
    if isinstance(scaling, int):
        scaling = [scaling, scaling]
    sx, sy = scaling
    if not (sx >= 1 and sy >= 1):
        raise ValueError(f"scaling must be >= 1, got {scaling}")
    return int(sx), int(sy)


def _parse_padding(padding) -> list[int]:
    if isinstance(padding, int):
        padding = [padding, padding]
    padding = list(padding)
    if len(padding) == 2:
        padx, pady = padding
        padding = [padx, padx, pady, pady]
    return [int(p) for p in padding]


def _as_filter(f) -> torch.Tensor:
    if isinstance(f, torch.Tensor):
        return f.detach().to(torch.float32)
    return torch.as_tensor(np.asarray(f, np.float32))


def setup_filter(f: Filt, normalize: bool = True, flip_filter: bool = False,
                 gain: float = 1.0, separable: Optional[bool] = None,
                 device: Optional[torch.device | str] = None) -> torch.Tensor:
    """A float32 filter from taps (reference upfirdn2d.py:70-115): a 1D
    list of fewer than 8 taps becomes its outer product unless `separable`,
    normalised to sum 1, flipped on request and scaled by gain ** (ndim / 2)."""
    f = _as_filter(1 if f is None else f)
    if f.dim() not in (0, 1, 2) or f.numel() == 0:
        raise ValueError(f"a filter has 0 to 2 dimensions and some taps, got {tuple(f.shape)}")
    if f.dim() == 0:
        f = f[None]
    if separable is None:
        separable = f.dim() == 1 and f.numel() >= 8
    if f.dim() == 1 and not separable:
        f = torch.outer(f, f)
    if normalize:
        f = f / f.sum()
    if flip_filter:
        f = f.flip(list(range(f.dim())))
    f = f * (gain ** (f.dim() / 2))
    return f if device is None else f.to(device)


def _get_filter_size(f) -> tuple[int, int]:
    if f is None:
        return 1, 1
    if f.dim() == 1:
        return int(f.shape[0]), int(f.shape[0])
    return int(f.shape[-1]), int(f.shape[0])  # (fw, fh)


def _pad_crop(z: torch.Tensor, pads: Sequence[int]) -> torch.Tensor:
    """Zero-pad (positive entries) or crop (negative) the last two axes of
    z (.., H, W) by pads (x0, x1, y0, y1), as a convolution's padding."""
    x0, x1, y0, y1 = pads
    z = F.pad(z, [max(x0, 0), max(x1, 0), max(y0, 0), max(y1, 0)])
    return z[..., max(-y0, 0):z.shape[-2] - max(-y1, 0), max(-x0, 0):z.shape[-1] - max(-x1, 0)]


def _dw_pass(z: torch.Tensor, kern: torch.Tensor, up: tuple[int, int],
             pads: Sequence[int], down: tuple[int, int]) -> torch.Tensor:
    """One depthwise pass over z (B, C, H, W): zeros after each sample (up
    = (upy, upx)), pads (x0, x1, y0, y1), a correlation with kern (kh, kw)
    at stride down = (downy, downx)."""
    B, C, H, W = z.shape
    upy, upx = up
    if upy > 1 or upx > 1:
        z = z.reshape(B, C, H, 1, W, 1)
        z = F.pad(z, [0, upx - 1, 0, 0, 0, upy - 1]).reshape(B, C, H * upy, W * upx)
    z = _pad_crop(z, pads)
    w = kern.to(z.dtype)[None, None].expand(C, 1, *kern.shape).contiguous()
    return F.conv2d(z, w, stride=down, groups=C)


def upfirdn2d(x: torch.Tensor, f: Optional[torch.Tensor], up=1, down=1, padding=0,
              flip_filter: bool = False, gain: float = 1.0) -> torch.Tensor:
    """x: (B, H, W, C); f: (fh, fw), (taps,) separable, or None (identity).
    The filter runs in x's dtype, as JAX's casts its kernel."""
    upx, upy = _parse_scaling(up)
    downx, downy = _parse_scaling(down)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    f = torch.ones((1, 1)) if f is None else _as_filter(f)
    f = f.to(x.device) * (gain ** (f.dim() / 2))
    if not flip_filter:
        f = f.flip(list(range(f.dim())))
    z = x.permute(0, 3, 1, 2)
    if f.dim() == 2:
        z = _dw_pass(z, f, (upy, upx), (padx0, padx1, pady0, pady1), (downy, downx))
    else:
        # separable: vertical, then horizontal
        z = _dw_pass(z, f[:, None], (upy, 1), (0, 0, pady0, pady1), (downy, 1))
        z = _dw_pass(z, f[None, :], (1, upx), (padx0, padx1, 0, 0), (1, downx))
    return z.permute(0, 2, 3, 1)


def filter2d(x, f, padding=0, flip_filter=False, gain=1.0):
    """Same-resolution filtering (reference upfirdn2d.py:277-310)."""
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = [padx0 + fw // 2, padx1 + (fw - 1) // 2, pady0 + fh // 2, pady1 + (fh - 1) // 2]
    return upfirdn2d(x, f, padding=p, flip_filter=flip_filter, gain=gain)


def upsample2d(x, f, up=2, padding=0, flip_filter=False, gain=1.0):
    """Upsampling with a FIR filter (reference upfirdn2d.py:313-349)."""
    upx, upy = _parse_scaling(up)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = [padx0 + (fw + upx - 1) // 2, padx1 + (fw - upx) // 2,
         pady0 + (fh + upy - 1) // 2, pady1 + (fh - upy) // 2]
    return upfirdn2d(x, f, up=up, padding=p, flip_filter=flip_filter, gain=gain * upx * upy)


def downsample2d(x, f, down=2, padding=0, flip_filter=False, gain=1.0):
    """Downsampling with a FIR filter (reference upfirdn2d.py:352-389)."""
    downx, downy = _parse_scaling(down)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = [padx0 + (fw - downx + 1) // 2, padx1 + (fw - downx) // 2,
         pady0 + (fh - downy + 1) // 2, pady1 + (fh - downy) // 2]
    return upfirdn2d(x, f, down=down, padding=p, flip_filter=flip_filter, gain=gain)


def filtered_lrelu(x: torch.Tensor, fu: Optional[torch.Tensor] = None,
                   fd: Optional[torch.Tensor] = None, b: Optional[torch.Tensor] = None,
                   up: int = 1, down: int = 1, padding=0, gain: float = float(np.sqrt(2)),
                   slope: float = 0.2, clamp: Optional[float] = None,
                   flip_filter: bool = False) -> torch.Tensor:
    """Upsample -> bias -> leaky ReLU -> clamp -> downsample (the reference's
    _filtered_lrelu_ref, torch_utils/ops/filtered_lrelu.py:121-156, as the
    JAX package composes it): the bias added, upfirdn2d(up) with the raw
    padding (no centring offsets, unlike upsample2d), bias_act(lrelu, gain,
    clamp), then upfirdn2d(down) with no padding."""
    from dpot_tpu_torch.ops.bias_act import bias_act

    px0, px1, py0, py1 = _parse_padding(padding)
    if b is not None:
        x = x + b.reshape(1, 1, 1, -1)
    x = upfirdn2d(x, fu, up=up, padding=[px0, px1, py0, py1], gain=up ** 2,
                  flip_filter=flip_filter)
    # elementwise (no bias): on the channels-first memory that upfirdn2d's
    # result views, as rows of C, which keeps the kernel's vector path
    xc = x.permute(0, 3, 1, 2).contiguous()
    x = bias_act(xc.view(-1, x.shape[-1]), None, act="lrelu", alpha=slope, gain=gain,
                 clamp=clamp).view(xc.shape).permute(0, 2, 3, 1)
    return upfirdn2d(x, fd, down=down, flip_filter=flip_filter)
