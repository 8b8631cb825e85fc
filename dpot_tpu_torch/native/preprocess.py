"""numpy-facing wrappers over the host preprocessing library (preprocess.cc),
each beside its plain numpy version.

The wrappers run the library; the plain versions run only where
`get_library()` returns None, which is where the caller set
DPOT_DISABLE_NATIVE=1. The resizes' plain version is data/resize.py
`resize_linear_nd` (the same arithmetic in numpy, within 1e-5: it rounds
the weights' product in another order); the assembly's and the bf16
conversion's are bit for bit.

bfloat16 on the host: numpy has no bfloat16 without ml_dtypes, so a bf16
buffer here is a uint16 array of bf16 words, usually the numpy view of a
torch.bfloat16 tensor (`bf16_words`).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from dpot_tpu_torch.data.resize import resize_linear_nd
from dpot_tpu_torch.native.build import get_library

_FP = ctypes.POINTER(ctypes.c_float)
_U16P = ctypes.POINTER(ctypes.c_uint16)


def _threads() -> int:
    """Threads a library call splits its rows over: torch's intra-op
    thread count, so that torch.set_num_threads bounds both."""
    return torch.get_num_threads()


def _fp(a: np.ndarray):
    return a.ctypes.data_as(_FP)


def bf16_words(t: torch.Tensor) -> np.ndarray:
    """The uint16 numpy view of a CPU torch.bfloat16 tensor's words."""
    if t.dtype != torch.bfloat16:
        raise TypeError(f"expected a bfloat16 tensor, got {t.dtype}")
    return t.view(torch.int16).numpy().view(np.uint16)


def f32_to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> bf16 words, rounded to nearest even, NaN quietened (the
    plain version of preprocess.cc f32_to_bf16)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    rounded = ((u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1)))
               >> np.uint32(16)).astype(np.uint16)
    quiet = ((u >> np.uint32(16)) | np.uint32(0x0040)).astype(np.uint16)
    return np.where((u & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000), quiet, rounded)


def resize_bilinear_2d(x: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """(H, W, ...trailing) -> (oh, ow, ...trailing)."""
    if tuple(x.shape[:2]) == tuple(out_hw):
        return np.ascontiguousarray(x, np.float32)
    lib = get_library()
    if lib is None:
        return resize_linear_nd(x, out_hw)
    H, W = x.shape[:2]
    xin = np.ascontiguousarray(x, np.float32)
    out = np.empty((*out_hw, *x.shape[2:]), np.float32)
    F = int(np.prod(x.shape[2:]))
    lib.resize_bilinear_2d(_fp(xin), _fp(out), H, W, F, out_hw[0], out_hw[1], _threads())
    return out


def pad_data_2d(x: np.ndarray, res: int, c_max: int) -> np.ndarray:
    """(H, W, T, C) -> (res, res, T, c_max): bilinear resize and ONES
    channel padding in one pass."""
    H, W, T, C = x.shape
    if C > c_max:
        # the library writes channel c of c_max for c < C: past the row's end
        # when C > c_max; the numpy path would fail on shapes instead
        raise ValueError(
            f"sample has {C} channels > c_max={c_max}; channel TRUNCATION "
            "is not a supported conversion (slice the corpus instead)"
        )
    lib = get_library()
    if (H, W) == (res, res) or lib is None:
        y = np.ascontiguousarray(x, np.float32) if (H, W) == (res, res) else \
            resize_linear_nd(x, (res, res))
        if C < c_max:
            y = np.concatenate([y, np.ones((res, res, T, c_max - C), np.float32)], axis=-1)
        return y
    xin = np.ascontiguousarray(x, np.float32)
    out = np.empty((res, res, T, c_max), np.float32)
    lib.pad_data_2d(_fp(xin), _fp(out), H, W, T, C, res, c_max, _threads())
    return out


def resize_trilinear_3d(x: np.ndarray, out_size: tuple[int, int, int]) -> np.ndarray:
    """(H, W, L, ...trailing) -> out_size + trailing."""
    H, W, L = x.shape[:3]
    if (H, W, L) == tuple(out_size):
        return np.ascontiguousarray(x, np.float32)
    lib = get_library()
    if lib is None:
        return resize_linear_nd(x, out_size)
    xin = np.ascontiguousarray(x, np.float32)
    out = np.empty((*out_size, *x.shape[3:]), np.float32)
    F = int(np.prod(x.shape[3:]))
    lib.resize_trilinear_3d(_fp(xin), _fp(out), H, W, L, F, *out_size, _threads())
    return out


def _check_slot(a: np.ndarray, what: str) -> None:
    if not a.flags.c_contiguous or a.dtype not in (np.float32, np.uint16):
        raise ValueError(f"{what} must be a C-contiguous float32 or uint16 (bf16 words) "
                         f"array, got {a.dtype}, contiguous={a.flags.c_contiguous}")


def assemble_windows(srcs: Sequence[np.ndarray], out_x: np.ndarray, out_y: np.ndarray) -> None:
    """Rows of out_x and out_y ((n, ...) each, C-contiguous, float32 or
    uint16 bf16 words) from n contiguous float32 windows: source j holds
    row j of x followed by row j of y. One GIL-released call fills the
    whole batch; a bf16 slot is rounded to nearest even on the way."""
    n = len(srcs)
    _check_slot(out_x, "out_x")
    _check_slot(out_y, "out_y")
    if out_x.shape[0] < n or out_y.shape[0] < n:
        raise ValueError(f"slots {out_x.shape} / {out_y.shape} do not hold {n} rows")
    x_elems = int(np.prod(out_x.shape[1:]))
    y_elems = int(np.prod(out_y.shape[1:]))
    for s in srcs:
        if s.dtype != np.float32 or not s.flags.c_contiguous or s.size != x_elems + y_elems:
            raise ValueError(f"source window {s.dtype}{s.shape} is not {x_elems} + {y_elems} "
                             "contiguous float32 elements")
    if n == 0:
        return
    if out_x.dtype != out_y.dtype:
        # one pass a slot (e.g. bf16 x, f32 y), each reading its part
        flat = [s.reshape(-1) for s in srcs]
        assemble_windows([f[:x_elems] for f in flat], out_x,
                         np.empty((out_x.shape[0], 0), out_x.dtype))
        assemble_windows([f[x_elems:] for f in flat], out_y,
                         np.empty((out_y.shape[0], 0), out_y.dtype))
        return
    lib = get_library()
    if lib is None:
        bf16 = out_x.dtype == np.uint16
        xs, ys = out_x.reshape(out_x.shape[0], -1), out_y.reshape(out_y.shape[0], -1)
        for j, s in enumerate(srcs):
            flat = s.reshape(-1)
            xs[j] = f32_to_bf16_bits(flat[:x_elems]) if bf16 else flat[:x_elems]
            ys[j] = f32_to_bf16_bits(flat[x_elems:]) if bf16 else flat[x_elems:]
        return
    ptrs = np.array([s.ctypes.data for s in srcs], np.uint64)  # srcs stay referenced
    pp = ptrs.ctypes.data_as(ctypes.POINTER(ctypes.c_void_p))
    if out_x.dtype == np.float32:
        lib.assemble_windows_f32(pp, _fp(out_x), _fp(out_y), n, x_elems, y_elems, _threads())
    else:
        lib.assemble_windows_bf16(pp, out_x.ctypes.data_as(_U16P), out_y.ctypes.data_as(_U16P),
                                  n, x_elems, y_elems, _threads())


def copy_to_bf16(dst: np.ndarray, src: np.ndarray) -> None:
    """dst (a C-contiguous uint16 array of bf16 words, e.g. a batch slot's
    row) = src rounded to bf16, shapes equal."""
    if tuple(dst.shape) != tuple(src.shape):
        raise ValueError(f"bf16 slot shape {tuple(dst.shape)} != item shape {tuple(src.shape)}")
    _check_slot(dst, "a bf16 slot")  # before reshape, which would copy some layouts
    src = np.ascontiguousarray(src, np.float32)
    assemble_windows([src.reshape(-1)], dst.reshape(1, -1), np.empty((1, 0), np.uint16))
