"""Host-side resampling (numpy; the port's copy of dpot_tpu/data/resize.py),
matching torch.nn.functional.interpolate
semantics used by the reference data layer (griddataset.py:96: bilinear,
align_corners=False; griddataset.py:497: trilinear).

Implemented as separable 1D linear interpolation with half-pixel centers —
the exact algorithm torch uses for (bi/tri)linear align_corners=False —
vectorized as gather+lerp per axis.
"""

from __future__ import annotations

import numpy as np


def _linear_axis_weights(n_in: int, n_out: int, align_corners: bool = False):
    """Indices/weights for 1D linear resize. align_corners=False uses
    half-pixel centers; True maps endpoints to endpoints (both exactly as
    torch.nn.functional.interpolate)."""
    if n_in == n_out:
        idx0 = np.arange(n_in)
        return idx0, idx0, np.ones(n_in, dtype=np.float32)
    if align_corners:
        x = np.arange(n_out, dtype=np.float64) * ((n_in - 1) / max(n_out - 1, 1))
    else:
        x = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    x = np.clip(x, 0.0, n_in - 1.0)
    i0 = np.floor(x).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    w1 = (x - i0).astype(np.float32)
    return i0, i1, 1.0 - w1


def resize_linear_nd(
    x: np.ndarray, out_size: tuple[int, ...], align_corners: bool = False
) -> np.ndarray:
    """Resize the leading len(out_size) axes of x by separable linear
    interpolation. Trailing axes are untouched."""
    x = np.asarray(x, dtype=np.float32)
    for axis, n_out in enumerate(out_size):
        n_in = x.shape[axis]
        if n_in == n_out:
            continue
        i0, i1, w0 = _linear_axis_weights(n_in, n_out, align_corners)
        a = np.take(x, i0, axis=axis)
        b = np.take(x, i1, axis=axis)
        shape = [1] * x.ndim
        shape[axis] = n_out
        w0b = w0.reshape(shape)
        x = a * w0b + b * (1.0 - w0b)
    return x
