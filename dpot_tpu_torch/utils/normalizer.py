"""Data normalizers (the port's copy of dpot_tpu/utils/normalizer.py).

Ports of reference utils/normalizer.py: UnitTransformer (:98-122),
MinMaxTransformer (:125-148), PointWiseUnitTransformer (:155-185),
IdentityTransformer and the quantile transformers. The numpy ones are the
JAX package's, unchanged; stats use ddof=1 (torch's unbiased .std()).
`DifferentiableQuantileTransformer` and `interp1d` are torch, and autograd
differentiates them.

Note: the reference dataset path that slices normalizer stats by timestep
(griddataset.py:166) indexes a size-1 axis and only works because
`normalize=False` everywhere in the entry scripts; here stats broadcast
(size-1 time axis) so the path is actually usable.
"""

from __future__ import annotations

import numpy as np
import torch


class IdentityTransformer:
    def __init__(self, X=None, eps: float = 0.0):
        self.mean = np.zeros(1, dtype=np.float32)
        self.std = np.ones(1, dtype=np.float32)
        self.eps = eps

    def transform(self, X, inverse=True, component="all"):
        return X


class UnitTransformer:
    """Per-channel mean/std over all leading axes."""

    def __init__(self, X: np.ndarray, eps: float = 1e-3):
        X = np.asarray(X, dtype=np.float32)
        axes = tuple(range(X.ndim - 1))
        self.mean = X.mean(axis=axes, keepdims=True)
        self.std = X.std(axis=axes, keepdims=True, ddof=1)
        self.eps = eps

    def transform(self, X, inverse=True, component="all"):
        if component in ("all", "all-reduce"):
            if inverse:
                return X * (self.std + self.eps) + self.mean
            return (X - self.mean) / (self.std + self.eps)
        if inverse:
            return X * (self.std[..., component] + self.eps) + self.mean[..., component]
        return (X - self.mean[..., component]) / (self.std[..., component] + self.eps)


class MinMaxTransformer:
    def __init__(self, X: np.ndarray, eps: float = 1e-4):
        X = np.asarray(X, dtype=np.float32)
        axes = tuple(range(X.ndim - 1))
        self.min = X.min(axis=axes, keepdims=True)
        self.max = X.max(axis=axes, keepdims=True)
        self.eps = eps

    def transform(self, X, inverse=True, component="all"):
        rng = self.max - self.min + self.eps
        if component in ("all", "all-reduce"):
            if inverse:
                return X * rng + self.min
            return (X - self.min) / rng
        if inverse:
            return X * rng[..., component] + self.min[..., component]
        return (X - self.min[..., component]) / rng[..., component]


class PointWiseUnitTransformer:
    """Per-gridpoint mean/std (over samples, and time if temporal)."""

    def __init__(self, X: np.ndarray, temporal: bool = True, eps: float = 1e-4):
        X = np.asarray(X, dtype=np.float32)
        axes = (0, X.ndim - 2) if temporal else (0,)
        self.mean = X.mean(axis=axes, keepdims=True)
        self.std = X.std(axis=axes, keepdims=True, ddof=1)
        self.eps = eps

    def transform(self, X, inverse=True, component="all"):
        if component in ("all", "all-reduce"):
            if inverse:
                return X * (self.std + self.eps) + self.mean
            return (X - self.mean) / (self.std + self.eps)
        if inverse:
            return X * (self.std[..., component] + self.eps) + self.mean[..., component]
        return (X - self.mean[..., component]) / (self.std[..., component] + self.eps)


class QuantileTransformer:
    """Per-channel quantile (rank-gaussian/uniform) transformer — port of
    the reference's TorchQuantileTransformer + custom Interp1d
    (utils/normalizer.py:194-463) on numpy: fit per-channel quantiles,
    transform by piecewise-linear interpolation onto [0,1] (or its
    inverse). Invertible within the fitted range."""

    def __init__(self, X: np.ndarray, n_quantiles: int = 1000):
        # ONE quantile-fitting implementation (fit_quantiles): NaN-robust
        # (nanpercentile) and monotonicity-enforced — np.quantile here
        # would NaN-poison the tables and fp-noise could break
        # np.interp's increasing-xp requirement
        self.references, self.quantiles = fit_quantiles(
            np.asarray(X, dtype=np.float32), n_quantiles
        )

    def transform(self, X, inverse=True, component="all"):
        # inverse=True default matches every other transformer in this
        # module (and the reference TorchQuantileTransformer) — a
        # polymorphic caller must get the denormalizing direction
        X = np.asarray(X, dtype=np.float32)
        C = X.shape[-1]
        out = np.empty_like(X)
        for c in range(C):
            if inverse:
                out[..., c] = np.interp(
                    X[..., c], self.references, self.quantiles[:, c]
                )
            else:
                out[..., c] = np.interp(
                    X[..., c], self.quantiles[:, c], self.references
                )
        return out


def fit_quantiles(X: np.ndarray, n_quantiles: int = 1000):
    """Fit per-channel quantile tables the way sklearn's
    QuantileTransformer does (the reference fits with sklearn and wraps the
    tables in TorchQuantileTransformer, griddataset.py:736-749).

    X: (..., C). Returns (references (n_q,), quantiles (n_q, C))."""
    X = np.asarray(X, dtype=np.float32)
    C = X.shape[-1]
    flat = X.reshape(-1, C)
    n_q = min(n_quantiles, flat.shape[0])
    references = np.linspace(0.0, 1.0, n_q, dtype=np.float64)
    quantiles = np.stack(
        [np.nanpercentile(flat[:, c], references * 100) for c in range(C)],
        axis=-1,
    ).astype(np.float32)
    # sklearn enforces monotonicity against fp noise
    quantiles = np.maximum.accumulate(quantiles, axis=0)
    return references.astype(np.float32), quantiles


def interp1d(x: torch.Tensor, y: torch.Tensor, xnew: torch.Tensor) -> torch.Tensor:
    """Differentiable piecewise-linear 1D interpolation (torch).

    Port of the reference's custom Interp1d autograd Function
    (utils/normalizer.py:194-353): searchsorted for the left neighbour,
    index clamped to [0, N-2], then ynew = y[ind] + slope[ind]*(xnew-x[ind])
    with an eps guard on the slope denominator, so values outside the x
    range extrapolate linearly from the first/last segment. Autograd gives
    the gradients with respect to y, x and xnew through the gather and the
    arithmetic.

    x, y: (N,) sorted knots and values; xnew: any shape. Returns xnew-shaped.
    """
    eps = torch.finfo(y.dtype).eps
    ind = torch.clamp(torch.searchsorted(x.detach().contiguous(), xnew.detach().contiguous()) - 1,
                      0, x.shape[0] - 2)
    slopes = (y[1:] - y[:-1]) / (eps + (x[1:] - x[:-1]))
    return y[ind] + slopes[ind] * (xnew - x[ind])


class DifferentiableQuantileTransformer:
    """Quantile (rank-gaussian / rank-uniform) transformer with a full
    gradient path, the counterpart of the reference's
    TorchQuantileTransformer + Interp1d autograd (utils/normalizer.py:
    194-463). All ops are torch, so `transform` can sit inside a model
    pipeline that autograd differentiates.

    Semantics matched to the reference transform_col:
    - forward: mean of ascending and flipped-descending interpolations
      (handles repeated quantiles), bound snapping with the 1e-7
      BOUNDS_THRESHOLD, then ndtri + clip for output_distribution='normal';
    - inverse: ndtr first (normal), then interpolate references->quantiles,
      bound snapping at 0/1.
    """

    BOUNDS_THRESHOLD = 1e-7

    def __init__(self, X=None, output_distribution: str = "normal",
                 n_quantiles: int = 1000, references=None, quantiles=None):
        if references is None or quantiles is None:
            references, quantiles = fit_quantiles(X, n_quantiles)
        self.references = torch.as_tensor(np.asarray(references, np.float32))  # (n_q,)
        self.quantiles = torch.as_tensor(np.asarray(quantiles, np.float32))  # (n_q, C)
        self.output_distribution = output_distribution
        # clip so inverse(transform(x)) stays consistent at the tails
        # (reference utils/normalizer.py:370-373), computed in float64
        t = torch.tensor(self.BOUNDS_THRESHOLD - np.spacing(1), dtype=torch.float64)
        self.clip_min = float(torch.special.ndtri(t))
        self.clip_max = float(torch.special.ndtri(1 - t))

    def _col(self, x: torch.Tensor, q: torch.Tensor, inverse: bool) -> torch.Tensor:
        normal = self.output_distribution == "normal"
        refs = self.references.to(x.device)
        if not inverse:
            lo_x, hi_x = q[0], q[-1]
            lo_y, hi_y = 0.0, 1.0
        else:
            lo_x, hi_x = 0.0, 1.0
            lo_y, hi_y = q[0], q[-1]
            if normal:
                x = torch.special.ndtr(x)

        if normal:
            lo_idx = x - self.BOUNDS_THRESHOLD < lo_x
            hi_idx = x + self.BOUNDS_THRESHOLD > hi_x
        else:
            lo_idx = x == lo_x
            hi_idx = x == hi_x

        if not inverse:
            # two-sided interpolation mean (repeated-quantile handling,
            # reference utils/normalizer.py:417-425)
            out = 0.5 * (interp1d(q, refs, x)
                         - interp1d(-torch.flip(q, [0]), -torch.flip(refs, [0]), -x))
        else:
            out = interp1d(refs, q, x)

        hi_y = torch.as_tensor(hi_y, dtype=out.dtype, device=out.device)
        lo_y = torch.as_tensor(lo_y, dtype=out.dtype, device=out.device)
        out = torch.where(hi_idx, hi_y, torch.where(lo_idx, lo_y, out))
        if not inverse and normal:
            out = torch.clamp(torch.special.ndtri(out), self.clip_min, self.clip_max)
        return out

    def transform(self, X, inverse: bool = True, component: str = "all") -> torch.Tensor:
        X = torch.as_tensor(X)
        q = self.quantiles.to(X.device)
        cols = [self._col(X[..., c], q[:, c], inverse) for c in range(X.shape[-1])]
        return torch.stack(cols, dim=-1)


def init_normalizer(kind: str, X: np.ndarray, **kw):
    table = {
        "unit": UnitTransformer,
        "minmax": MinMaxTransformer,
        "pointwise": PointWiseUnitTransformer,
        "quantile": QuantileTransformer,
        "quantile_diff": DifferentiableQuantileTransformer,
        "identity": IdentityTransformer,
        "none": IdentityTransformer,
    }
    return table[kind](X, **kw)
