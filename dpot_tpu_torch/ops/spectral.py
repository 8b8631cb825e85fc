"""AFNO spectral mixers in plain PyTorch (port of dpot_tpu/ops/spectral.py
and the `xla` branches of dpot_tpu/ops/fourier.py).

For a latent grid of at most 4096 pixels the whole rfft2 -> kept corner ->
irfft2 pipeline is two matrix products with fixed real operators A (2K, HW)
and Ainv (HW, 2K). They are built once with numpy's FFT and cached as device
tensors per (H, W, kh, kw, dtype, device), so an eager forward never copies
them from the host again. Larger 2D latents take the separable branch, and
the 3D mixer always does: a real FFT over the spatial axes (`torch.fft`,
cuFFT on the card, in float32 whatever the compute type, as JAX's XLA FFT),
the mode MLP on the kept corner, and the inverse FFT of the zero-padded
spectrum. `separable_gn_afno` is the 2D block's route for those latents,
GroupNorm and then that branch; `separable_gn_afno.calls` counts its calls.

`spectral_resize` and `resize_temporal` resample a field in Fourier space,
for the evaluator's resolution sweep.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from dpot_tpu_torch.ops.cuda.graphs import capturing
from dpot_tpu_torch.ops.norms import group_norm

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
        raise ValueError(
            f"latent {H}x{W} exceeds {COMBINED_MAX_PIXELS} px, the combined operators' "
            "limit: such latents take the separable route (afno_filter_2d's separable "
            "branch, ROADMAP item 3)")
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


def rfftn_pair(x: torch.Tensor, dims: tuple[int, ...],
               norm: str = "ortho") -> tuple[torch.Tensor, torch.Tensor]:
    """Real FFT of x over `dims` (the last one halved to n//2+1): (re, im),
    as JAX's rfft2_pair / rfft3_pair return them. norm "ortho" (AFNO's) or
    "backward" (FNO's, torch's default)."""
    f = torch.fft.rfftn(x, dim=dims, norm=norm)
    return f.real, f.imag


def irfftn_pair(re: torch.Tensor, im: torch.Tensor, s: tuple[int, ...],
                dims: tuple[int, ...], norm: str = "ortho") -> torch.Tensor:
    """Inverse of rfftn_pair to the real sizes `s` over `dims` (JAX's
    irfft2_pair / irfft3_pair), with the same `norm`: the complex inverse
    over the leading dims, then the real inverse over the last one, whose
    DC bin (and Nyquist bin, for an even size) lose their imaginary parts
    first. A spectrum that a mode MLP or a spectral convolution has
    changed is not Hermitian there, and the real inverse of such an input
    is the library's choice: the CPU's (and JAX's DFT) drops those
    imaginary parts, cuFFT's does not (an FNO2d spectral convolution at
    128^2 came out 12 % off on the H100), so they are dropped here."""
    z = torch.complex(re, im)
    if len(dims) > 1:
        z = torch.fft.ifftn(z, s=s[:-1], dim=dims[:-1], norm=norm)
    last, n = dims[-1], s[-1]
    zi = z.imag.clone()
    for b in (0, n // 2) if n % 2 == 0 else (0,):
        if b < zi.shape[last]:
            zi.select(last, b).zero_()
    return torch.fft.irfft(torch.complex(z.real, zi), n=n, dim=last, norm=norm)


def fft2_pair(x: torch.Tensor, dims: tuple[int, int] = (-2, -1)
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full complex 2D FFT of a real x over `dims`, unscaled: (re, im), as
    JAX's fft2_pair of a real input."""
    f = torch.fft.fft2(x, dim=dims)
    return f.real, f.imag


def ifft2_pair(re: torch.Tensor, im: torch.Tensor, dims: tuple[int, int] = (-2, -1)
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full inverse 2D FFT (scaled by 1/(H*W)) of a (re, im) pair."""
    f = torch.fft.ifft2(torch.complex(re, im), dim=dims)
    return f.real, f.imag


def _corner_mlp(x32: torch.Tensor, corner: tuple[int, ...], w1, b1, w2, b2, act,
                compute_dtype) -> torch.Tensor:
    """The mode MLP on the kept corner of x32's spectrum over its spatial
    axes (1 .. n), the rest of the spectrum zero, transformed back to x32's
    grid: the filter output before the residual, float32."""
    B, *grid, C = x32.shape
    nb = w1.shape[1]
    dims = tuple(range(1, len(grid) + 1))
    fr, fi = rfftn_pair(x32, dims)
    idx = (slice(None),) + tuple(slice(0, k) for k in corner)
    N = B * math.prod(corner)
    o_re, o_im = afno_mode_mlp(fr[idx].reshape(N, nb, C // nb), fi[idx].reshape(N, nb, C // nb),
                               w1, b1, w2, b2, act, compute_dtype)
    # the corner back into an otherwise zero spectrum (F.pad lists the
    # last axis first)
    pad = [0, 0]
    for k, n in reversed(list(zip(corner, fr.shape[1:-1]))):
        pad += [0, n - k]
    o_re = F.pad(o_re.float().reshape(B, *corner, C), pad)
    o_im = F.pad(o_im.float().reshape(B, *corner, C), pad)
    return irfftn_pair(o_re, o_im, tuple(grid), dims)


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
    output (they survive only through the residual). Latents of at most
    COMBINED_MAX_PIXELS take the combined operators, whose products under
    bf16 compute take bf16 operands and accumulate in f32; larger ones the
    separable branch (float32 FFTs, the mode MLP in the compute type)."""
    B, H, W, C = x.shape
    nb = w1.shape[1]
    bs = C // nb
    kh, kw = kept_modes(H, W, modes)
    if H * W > COMBINED_MAX_PIXELS:
        x32 = x.float()
        y = _corner_mlp(x32, (kh, kw), w1, b1, w2, b2, act, compute_dtype)
        return (y + x32).to(x.dtype)
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


def separable_gn_afno(
    x: torch.Tensor, gscale: torch.Tensor, gbias: torch.Tensor, groups: int,
    w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
    modes: int, act: Callable[[torch.Tensor], torch.Tensor],
) -> torch.Tensor:
    """The 2D block's norm1 and mixer for latents above COMBINED_MAX_PIXELS,
    the JAX package's own route for them (no kernel exists for it on either
    side): GroupNorm, then afno_filter_2d's separable branch on the normed
    x, whose residual is that x in its own dtype. x: (B, H, W, C) of the
    compute dtype. Counts its calls in `separable_gn_afno.calls`."""
    H, W = x.shape[1:3]
    if H * W <= COMBINED_MAX_PIXELS:
        raise ValueError(f"a {H}x{W} latent takes the fused route, not the separable one")
    separable_gn_afno.calls += 1
    xn = group_norm(x, gscale, gbias, groups)
    return afno_filter_2d(xn, w1, b1, w2, b2, modes, act, x.dtype)


separable_gn_afno.calls = 0


def afno_filter_3d(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    modes: int,
    temporal_modes: int,
    act: Callable[[torch.Tensor], torch.Tensor],
    compute_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """AFNO 3D spectral mixer with its internal residual, channels-last
    (dpot_tpu/ops/spectral.py afno_filter_3d). x: (B, X, Y, Z, C), taken to
    float32 for the FFT; the kept corner of the rfftn half-spectrum is
    [:min(modes, X), :min(modes, Y), :min(temporal_modes, Z//2+1)] (the
    second axis is not halved, as in the reference); the residual y + x32
    is cast to x's dtype."""
    H, W, L = x.shape[1:4]
    x32 = x.float()
    corner = (min(modes, H), min(modes, W), min(temporal_modes, L // 2 + 1))
    y = _corner_mlp(x32, corner, w1, b1, w2, b2, act, compute_dtype)
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
