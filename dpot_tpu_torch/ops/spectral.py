"""AFNO spectral mixer in plain PyTorch (port of the combined-operator
branch of dpot_tpu/ops/spectral.py).

For a latent grid of at most 4096 pixels the whole rfft2 -> kept corner ->
irfft2 pipeline is two matrix products with fixed real operators A (2K, HW)
and Ainv (HW, 2K). They are built once with numpy's FFT and cached as device
tensors per (H, W, kh, kw, dtype, device), so an eager forward never copies
them from the host again. The separable per-axis DFT for larger latents is
not ported yet (ROADMAP, "Modules to port", separable-DFT item).

`spectral_resize` and `resize_temporal` resample a field in Fourier space,
for the evaluator's resolution sweep.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable

import numpy as np
import torch

from dpot_tpu_torch.ops.cuda.graphs import capturing

# latent grids up to this many pixels use the combined-operator path
COMBINED_MAX_PIXELS = 4096


def complex_as_real_weight(w_re: torch.Tensor, w_im: torch.Tensor) -> torch.Tensor:
    """Real form of a complex block weight: [zr zi] = [xr xi] @ [[wr, wi],
    [-wi, wr]]. w_re/w_im: (nb, I, O) -> (nb, 2I, 2O)."""
    top = torch.cat([w_re, w_im], dim=-1)
    bot = torch.cat([-w_im, w_re], dim=-1)
    return torch.cat([top, bot], dim=-2)


@lru_cache(maxsize=32)
def combined_spectral_ops_np(H: int, W: int, kh: int, kw: int):
    """Combined real analysis/synthesis operators for the kept mode corner,
    built by transforming basis vectors with numpy's FFT (ortho norm).

    A (2K, H*W):    pixels -> stacked [re; im] of the kept rfft2 corner
    Ainv (H*W, 2K): kept corner -> irfft2 of the zero-padded spectrum
    """
    n = H * W
    K = kh * kw
    eye = np.eye(n, dtype=np.float32).reshape(n, H, W)
    F = np.fft.rfft2(eye, axes=(1, 2), norm="ortho")[:, :kh, :kw].reshape(n, K)
    A = np.concatenate([F.real.T, F.imag.T], axis=0).astype(np.float32)

    Z = np.zeros((2 * K, H, W // 2 + 1), dtype=np.complex128)
    for m in range(K):
        h, k = divmod(m, kw)
        Z[m, h, k] = 1.0
        Z[K + m, h, k] = 1j
    Y = np.fft.irfft2(Z, s=(H, W), axes=(1, 2), norm="ortho").reshape(2 * K, n)
    Ainv = Y.T.astype(np.float32)
    return A, Ainv


@lru_cache(maxsize=None)
def combined_spectral_ops(
    H: int, W: int, kh: int, kw: int, dtype: torch.dtype, device: torch.device
) -> tuple[torch.Tensor, torch.Tensor]:
    """(A, Ainv) as tensors of `dtype` on `device`, uploaded once. They are
    made outside inference mode even when the first caller runs in it, so
    that a later training forward may save them for its backward. The cache
    never evicts: a CUDA graph reads them by address. A miss while a graph
    is being captured raises (the upload is a host-to-device copy): the
    capture's warm-up must have made them."""
    device = torch.device(device)
    if device.type == "cuda" and capturing():
        raise RuntimeError(
            f"the DFT operators of a {H}x{W} latent (modes {kh}x{kw}, {dtype}) are not "
            "cached on the card: a CUDA graph cannot upload them during its capture; "
            "run the function once eagerly first")
    if H * W > COMBINED_MAX_PIXELS:
        raise NotImplementedError(
            f"latent {H}x{W} exceeds {COMBINED_MAX_PIXELS} px: the separable "
            "DFT branch is not ported yet (ROADMAP, 'Modules to port', "
            "separable-DFT item)"
        )
    A, Ainv = combined_spectral_ops_np(H, W, kh, kw)
    with torch.inference_mode(False):
        return tuple(
            torch.from_numpy(np.ascontiguousarray(m)).to(device=device, dtype=dtype)
            for m in (A, Ainv)
        )


def kept_modes(H: int, W: int, modes: int) -> tuple[int, int]:
    """(kh, kw): the kept corner of the rfft2 half-spectrum."""
    return min(modes, H), min(modes, W // 2 + 1)


def afno_mode_mlp(
    x_re: torch.Tensor,
    x_im: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    act: Callable[[torch.Tensor], torch.Tensor],
    compute_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """2-layer complex block-diagonal MLP on kept Fourier modes.
    x_re, x_im: (N, nb, bs); weights in the reference layout
    w1 (2, nb, bs, bs), b1 (2, nb, bs), w2 (2, nb, bs, bs), b2 (2, nb, bs)."""
    bs = x_re.shape[-1]
    in_dtype = x_re.dtype
    cd = compute_dtype or in_dtype
    W1 = complex_as_real_weight(w1[0], w1[1]).to(cd)
    W2 = complex_as_real_weight(w2[0], w2[1]).to(cd)
    B1 = torch.cat([b1[0], b1[1]], dim=-1).to(cd)
    B2 = torch.cat([b2[0], b2[1]], dim=-1).to(cd)
    z = torch.cat([x_re, x_im], dim=-1).to(cd)
    h = act(torch.einsum("nbi,bio->nbo", z, W1) + B1)
    o = (torch.einsum("nbi,bio->nbo", h, W2) + B2).to(in_dtype)
    return o[..., :bs], o[..., bs:]


def afno_filter_2d(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    modes: int,
    act: Callable[[torch.Tensor], torch.Tensor],
    compute_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """AFNO 2D spectral mixer with its internal residual, channels-last.
    x: (B, H, W, C). Modes outside the kept corner are zeroed in the filter
    output (they survive only through the residual). Under bf16 compute the
    DFT products take bf16 operands and accumulate in f32."""
    B, H, W, C = x.shape
    nb = w1.shape[1]
    bs = C // nb
    kh, kw = kept_modes(H, W, modes)
    K = kh * kw
    mm = torch.bfloat16 if compute_dtype == torch.bfloat16 else torch.float32
    A, Ainv = combined_spectral_ops(H, W, kh, kw, mm, x.device)
    x32 = x.float()
    z = torch.matmul(A.float(), x32.reshape(B, H * W, C).to(mm).float())
    o_re, o_im = afno_mode_mlp(
        z[:, :K].reshape(B * K, nb, bs), z[:, K:].reshape(B * K, nb, bs),
        w1, b1, w2, b2, act, compute_dtype,
    )
    o = torch.cat([o_re.reshape(B, K, C), o_im.reshape(B, K, C)], dim=1)
    y = torch.matmul(Ainv.float(), o.to(mm).float()).reshape(B, H, W, C)
    return (y + x32).to(x.dtype)


def _resize_axes(x: torch.Tensor, out_size: tuple[int, int], dims: tuple[int, int]):
    """Fourier-domain resample of the real tensor x over `dims` (the
    reference's `resize`, utils/utilities.py:277-305): rfft2 with
    'backward' norm in f32, the low-frequency top and bottom bands copied
    into a zero spectrum of the target size, irfft2, the amplitude rescaled
    by (oh / H) * (ow / W), cast back to x's dtype. As numpy's and torch's
    irfft do, the inverse reads only the real part of the DC and Nyquist
    columns of the last axis."""
    d0, d1 = dims
    H, W = x.shape[d0], x.shape[d1]
    oh, ow = out_size
    f = torch.fft.rfft2(x.float(), dim=dims, norm="backward")
    top1 = min((H + 1) // 2, (oh + 1) // 2)
    top2 = min(f.shape[d1], ow // 2 + 1)
    bot1 = min(H // 2, oh // 2)
    shape = list(f.shape)
    shape[d0], shape[d1] = oh, ow // 2 + 1
    fz = f.new_zeros(shape)
    fz.narrow(d0, 0, top1).narrow(d1, 0, top2).copy_(
        f.narrow(d0, 0, top1).narrow(d1, 0, top2))
    fz.narrow(d0, oh - bot1, bot1).narrow(d1, 0, top2).copy_(
        f.narrow(d0, H - bot1, bot1).narrow(d1, 0, top2))
    y = torch.fft.irfft2(fz, s=(oh, ow), dim=dims, norm="backward")
    return (y * (oh / H) * (ow / W)).to(x.dtype)


def spectral_resize(x: torch.Tensor, out_size: tuple[int, int]) -> torch.Tensor:
    """Fourier-domain resample over the last two axes: x (..., H, W) ->
    (..., oh, ow)."""
    return _resize_axes(x, out_size, (x.dim() - 2, x.dim() - 1))


def resize_temporal(x: torch.Tensor, out_size: tuple[int, int]) -> torch.Tensor:
    """Spectral resize of a channels-last field (B, X, Y, T, C) over its
    spatial axes, the layout kept end to end."""
    return _resize_axes(x, out_size, (1, 2))
