"""The AFNO mixer with the latent's H axis sharded over 'spatial' (port of
dpot_tpu/parallel/dist_fft.py): the rfft2 as a pencil decomposition,

  local rfft over W -> W-frequencies padded to divide the axis
  -> all_to_all_single (gather H, split W-frequencies) -> local FFT over H
  -> the mode MLP on the kept corner -> local inverse FFT over H
  -> all_to_all_single back -> local irfft over W -> the residual.

Between the two transposes the work is local. The transforms are
`torch.fft` in float32 (cuFFT on the card); bf16 (`compute_dtype`) travels
only on the wire and runs the mode MLP, as in JAX. The inverse over W is
ops/spectral.py `irfftn_pair`, which drops the imaginary parts of the DC
and Nyquist bins first (cuFFT's real inverse would keep them). The mode MLP
runs on the kept corner only: rows [:kh] after the H-gather, and the kept
W-frequency columns, which are a prefix of every shard's local columns
(global column = shard * Wfp/s + j); a boundary shard's columns past the
corner are masked to zero after the MLP (whose biases would make them
non-zero). Numerics match ops/spectral.py `afno_filter_2d` on the whole
latent.

`all_to_all` is an autograd.Function whose backward is the same transpose
of the gradient (an all-to-all is its own adjoint in this layout).
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F

from dpot_tpu_torch.ops.spectral import afno_mode_mlp, irfftn_pair
from dpot_tpu_torch.parallel.mesh import Axis, as_words, from_words


class _AllToAll(torch.autograd.Function):
    """x (s, ...): chunk j goes to rank j, which puts it at this rank's slot."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    w = as_words(x.contiguous())
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=group)
    return from_words(out, x.dtype)


def all_to_all(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return _AllToAll.apply(x, axis.group)


def afno_filter_2d_sharded(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    modes: int,
    act: Callable[[torch.Tensor], torch.Tensor],
    axis: Axis,
    compute_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """AFNO 2D mixer with its internal residual on this rank's rows of the
    latent: x (B, H/s, W, C), s the 'spatial' axis's size. Weights in the
    reference layout (ops/spectral.py afno_mode_mlp). compute_dtype: None
    or float32 for the float32 path, bfloat16 for bf16 on the wire and in
    the mode MLP."""
    B, Hl, W, C = x.shape
    s, idx = axis.size, axis.rank
    H = Hl * s
    Wf = W // 2 + 1
    wfs = -(-Wf // s)  # W-frequencies a shard, padded
    kh, kw = min(modes, H), min(modes, Wf)
    nb = w1.shape[1]
    bs = C // nb
    scale = 1.0 / math.sqrt(H * W)
    wire = compute_dtype if compute_dtype not in (None, torch.float32) else None
    x32 = x.float()

    f = torch.fft.rfft(x32, dim=2)  # (B, H/s, Wf, C), unscaled
    z = torch.stack([f.real, f.imag])
    if wire is not None:
        z = z.to(wire)
    z = F.pad(z, (0, 0, 0, s * wfs - Wf))
    # gather H, split W-frequencies: chunk j (of columns) to rank j
    z = z.reshape(2, B, Hl, s, wfs, C).permute(3, 0, 1, 2, 4, 5)
    z = all_to_all(z, axis)  # slot j: rank j's rows of this rank's columns
    z = z.permute(1, 2, 0, 3, 4, 5).reshape(2, B, H, wfs, C).float()
    f = torch.fft.fft(torch.complex(z[0], z[1]), dim=1) * scale

    cw = min(wfs, kw)
    o_re, o_im = afno_mode_mlp(
        f.real[:, :kh, :cw].reshape(B * kh * cw, nb, bs),
        f.imag[:, :kh, :cw].reshape(B * kh * cw, nb, bs),
        w1, b1, w2, b2, act, compute_dtype=wire,
    )
    keep = (idx * wfs + torch.arange(cw, device=x.device) < kw)[None, None, :, None]
    pad = (0, 0, 0, wfs - cw, 0, H - kh)
    o_re = F.pad(torch.where(keep, o_re.float().reshape(B, kh, cw, C), 0.0), pad)
    o_im = F.pad(torch.where(keep, o_im.float().reshape(B, kh, cw, C), 0.0), pad)

    y = torch.fft.ifft(torch.complex(o_re, o_im), dim=1, norm="forward")  # unscaled
    z = torch.stack([y.real, y.imag])
    if wire is not None:
        z = z.to(wire)
    # split H, gather W-frequencies: rows of rank j to rank j
    z = z.reshape(2, B, s, Hl, wfs, C).permute(2, 0, 1, 3, 4, 5)
    z = all_to_all(z, axis)  # slot j: rank j's columns of this rank's rows
    z = z.permute(1, 2, 3, 0, 4, 5).reshape(2, B, Hl, s * wfs, C)[:, :, :, :Wf].float()
    y = irfftn_pair(z[0], z[1], (W,), (2,), norm="forward") * scale  # unscaled inverse
    return (y + x32).to(x.dtype)
