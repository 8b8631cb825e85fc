"""Losses and evaluation metrics (port of dpot_tpu/utils/criterion.py).

`rel_lp_loss` is the training and eval loss of the reference (SimpleLpLoss
with size_average=False). The metric battery mirrors the reference's
Evaluator and compute_fourier_error: nMAE/nMSE/nMXE, boundary RMSE and the
low/mid/high spectral-band MSE, for 1D, 2D and 3D fields, channels-last
(B, spatial..., T, C).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rel_lp_loss(
    pred: torch.Tensor,
    target: torch.Tensor,
    mask: torch.Tensor | None = None,
    p: int = 2,
    reduce_batch: bool = True,
) -> torch.Tensor:
    """Per-channel relative Lp norm over flattened space-time, masked, summed
    over channels, divided by the count of channels with a non-zero mask,
    summed over the batch (the reference's SimpleLpLoss, size_average=False).
    pred/target: (B, ..., C); mask broadcastable to them (the data layer
    gives (B, H, W, 1, C)). reduce_batch=False returns the per-sample
    vector."""
    B, C = pred.shape[0], pred.shape[-1]
    if mask is not None:
        x, y = pred * mask, target * mask
        # channels with any non-zero mask weight
        msk_channels = torch.count_nonzero(
            mask.sum(dim=tuple(range(1, mask.dim() - 1))), dim=-1
        ).to(x.dtype)
    else:
        x, y = pred, target
        msk_channels = torch.full((B,), C, dtype=torch.result_type(pred, target),
                                  device=pred.device)
    xf = x.reshape(B, -1, C)
    yf = y.reshape(B, -1, C)
    if p == 2:
        diff_norms = (xf - yf).square().sum(dim=1).sqrt()
        y_norms = yf.square().sum(dim=1).sqrt() + 1e-8
    else:
        diff_norms = (xf - yf).abs().pow(p).sum(dim=1).pow(1.0 / p)
        y_norms = yf.abs().pow(p).sum(dim=1).pow(1.0 / p) + 1e-8
    per_sample = (diff_norms / y_norms).sum(dim=-1) / msk_channels
    return per_sample.sum() if reduce_batch else per_sample


def cross_entropy_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """torch CrossEntropyLoss(reduction='sum') on (B, n_cls) logits and (B,)
    integer labels (the reference's dataset classifier loss)."""
    return F.cross_entropy(logits.float(), labels.long(), reduction="sum")


def lp_metric(pred: torch.Tensor, target: torch.Tensor, p: int = 2) -> torch.Tensor:
    """Component-wise absolute Lp metric (the reference's LpLoss): mean over
    batch and channels."""
    B, C = pred.shape[0], pred.shape[-1]
    d = (pred - target).reshape(B, -1, C)
    return d.abs().pow(p).mean(dim=1).pow(1.0 / p).mean()


def rel_lp_metric(pred: torch.Tensor, target: torch.Tensor, p: int = 2,
                  per_channel: bool = False) -> torch.Tensor:
    """Relative Lp metric (the reference's RelLpLoss, component='all')."""
    B, C = pred.shape[0], pred.shape[-1]
    err = (pred - target).reshape(B, -1, C).abs().pow(p).sum(dim=1)
    ref = target.reshape(B, -1, C).abs().pow(p).sum(dim=1)
    losses = (err / ref).pow(1.0 / p)  # (B, C)
    return losses.mean(dim=0) if per_channel else losses.mean()


def rfne_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Relative Frobenius-norm error ||pred - y||_F / ||y||_F over the
    spatial axes, leaving (B, T, C), then averaged (the reference RFNELoss's
    documented intent; its body passes sizes where axes are meant)."""
    axes = tuple(range(1, pred.dim() - 2))
    err = (pred - target).square().sum(dim=axes).sqrt()
    ref = target.square().sum(dim=axes).sqrt()
    return (err / ref).mean()


def _normalized_errors(p: torch.Tensor, t: torch.Tensor) -> dict[str, torch.Tensor]:
    """nMAE, nMSE, nMXE over axis 1, averaged over the batch."""
    d = p - t
    return {
        "nmae": (d.abs().sum(dim=1) / t.abs().sum(dim=1)).mean(dim=0),
        "nmse": (d.square().sum(dim=1) / t.square().sum(dim=1)).sqrt().mean(dim=0),
        "nmxe": (d.abs().amax(dim=1) / t.abs().amax(dim=1)).mean(dim=0),
    }


def evaluator_metrics(pred: torch.Tensor, target: torch.Tensor,
                      temporal: bool = False) -> dict[str, torch.Tensor]:
    """nMAE / nMSE / nMXE per channel (C,), and with temporal=True their
    per-frame variants nmae_t / nmse_t / nmxe_t (T, C), as the reference
    Evaluator. pred/target: (B, spatial..., T, C)."""
    B, C = pred.shape[0], pred.shape[-1]
    out = _normalized_errors(pred.reshape(B, -1, C), target.reshape(B, -1, C))
    if temporal:
        T = pred.shape[-2]
        per_frame = _normalized_errors(pred.reshape(B, -1, T, C),
                                       target.reshape(B, -1, T, C))
        out.update({f"{k}_t": v for k, v in per_frame.items()})
    return out


def boundary_rmse_1d(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Boundary RMSE of a 1D field (B, X, T, C): (C, T)."""
    p, t = pred.permute(0, 3, 1, 2), target.permute(0, 3, 1, 2)  # B, C, X, T
    err = (p[:, :, 0] - t[:, :, 0]).square() + (p[:, :, -1] - t[:, :, -1]).square()
    return (err / 2.0).sqrt().mean(dim=0)


def boundary_rmse_2d(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Boundary RMSE of a 2D field (B, X, Y, T, C): (C, T)."""
    p, t = pred.permute(0, 4, 1, 2, 3), target.permute(0, 4, 1, 2, 3)  # B, C, X, Y, T
    nx, ny = p.shape[2], p.shape[3]
    ebx = (p[:, :, 0] - t[:, :, 0]).square() + (p[:, :, -1] - t[:, :, -1]).square()
    eby = (p[:, :, :, 0] - t[:, :, :, 0]).square() + (p[:, :, :, -1] - t[:, :, :, -1]).square()
    err = (ebx.sum(dim=-2) + eby.sum(dim=-2)) / (2 * nx + 2 * ny)
    return err.sqrt().mean(dim=0)


def boundary_rmse_3d(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Boundary RMSE of a 3D field (B, X, Y, Z, T, C): (C, T). Channels stay
    apart, as in the 1D and 2D forms (the reference's 3D branch folds them
    into the face sum; the same at C = 1)."""
    p, t = pred.permute(0, 5, 1, 2, 3, 4), target.permute(0, 5, 1, 2, 3, 4)
    B, C, nx, ny, nz, nt = p.shape

    def face_sq(axis: int) -> torch.Tensor:
        e = ((p.select(axis, 0) - t.select(axis, 0)).square()
             + (p.select(axis, -1) - t.select(axis, -1)).square())
        return e.reshape(B, C, -1, nt).sum(dim=2)

    err = (face_sq(2) + face_sq(3) + face_sq(4)) / (2 * nx * ny + 2 * ny * nz + 2 * nz * nx)
    return err.sqrt().mean(dim=0)


def _bands(ef: torch.Tensor, ilow: int, ihigh: int):
    """(low, mid, high), each (T, C), from per-frequency errors ef (C, F, T):
    the means over [0, ilow), [ilow, ihigh) and [ihigh, F)."""
    return tuple(ef[:, sl].mean(dim=1).T
                 for sl in (slice(None, ilow), slice(ilow, ihigh), slice(ihigh, None)))


def _radial_bins(sizes: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """One-hot radial binning (prod(n // 2), nbin) of the low-frequency
    corner [0, n // 2) on every axis: bin floor(|k|), bins past
    min(n // 2) dropped."""
    half = [n // 2 for n in sizes]
    grids = torch.meshgrid(*[torch.arange(h, dtype=torch.float64) for h in half],
                           indexing="ij")
    radial = torch.floor(torch.sqrt(sum(g.square() for g in grids))).long()
    nbin = min(half)
    onehot = (radial.reshape(-1, 1) == torch.arange(nbin)).to(torch.float32)
    return onehot.to(device)


def _spectral_band_mse_nd(pred, target, ilow, ihigh, ndim: int):
    """The binned spectral MSE of an ndim-D field (B, spatial..., T, C) for
    ndim 2 and 3: |FFT(pred - target)|^2 over the spatial axes (unscaled),
    summed in radial bins over the low-frequency corner,
    sqrt(mean over B) / prod(n), then the band means."""
    perm = (0, ndim + 2, *range(1, ndim + 2))  # B, C, spatial..., T
    d = (pred.float() - target.float()).permute(perm)
    sizes = tuple(d.shape[2:2 + ndim])
    err = torch.fft.fftn(d, dim=tuple(range(2, 2 + ndim))).abs().square()
    corner = err[(slice(None), slice(None), *[slice(0, n // 2) for n in sizes])]
    B, C, T = d.shape[0], d.shape[1], d.shape[-1]
    binned = torch.einsum("bckt,kn->bcnt", corner.reshape(B, C, -1, T),
                          _radial_bins(sizes, d.device))
    ef = binned.mean(dim=0).sqrt() / math.prod(sizes)  # C, nbin, T
    return _bands(ef, ilow, ihigh)


def spectral_band_mse_1d(pred: torch.Tensor, target: torch.Tensor, ilow: int = 4,
                         ihigh: int = 12):
    """Low/mid/high-frequency spectral MSE of a 1D field (B, X, T, C): rfft
    over x (unscaled), sqrt(mean over B of |dF|^2) / nx, then the band means.
    Returns (low, mid, high), each (T, C)."""
    d = (pred.float() - target.float()).permute(0, 3, 1, 2)  # B, C, X, T
    err = torch.fft.rfft(d, dim=2).abs().square()
    ef = err.mean(dim=0).sqrt() / d.shape[2]
    return _bands(ef, ilow, ihigh)


def spectral_band_mse_2d(pred: torch.Tensor, target: torch.Tensor, ilow: int = 4,
                         ihigh: int = 12):
    """Low/mid/high-frequency spectral MSE of a 2D field (B, X, Y, T, C),
    radially binned over the [0, nx/2) x [0, ny/2) corner of the full FFT.
    Returns (low, mid, high), each (T, C); a band with no bin is NaN."""
    return _spectral_band_mse_nd(pred, target, ilow, ihigh, 2)


def spectral_band_mse_3d(pred: torch.Tensor, target: torch.Tensor, ilow: int = 4,
                         ihigh: int = 12):
    """The 3D form of spectral_band_mse_2d, for (B, X, Y, Z, T, C)."""
    return _spectral_band_mse_nd(pred, target, ilow, ihigh, 3)
