"""Fused GroupNorm + AFNO spectral mixer: the Hopper kernel and its plain
PyTorch version.

`fused_gn_afno` replaces the TPU kernel of the same name
(dpot_tpu/ops/pallas/afno_fused.py). For a CUDA tensor it launches the
hand-written kernel in `dpot_tpu_torch/csrc/afno_fused.cu` (five launches on
the current stream) or raises; for a CPU tensor it runs
`fused_gn_afno_ref`, which repeats the kernel's arithmetic with torch ops and
rounds at the same points. `fused_gn_afno.launches` counts the wrapper calls
that launched the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from dpot_tpu_torch.ops.norms import group_norm
from dpot_tpu_torch.ops.spectral import COMBINED_MAX_PIXELS, complex_as_real_weight

def fused_gn_afno_ref(
    x, gscale, gbias, A, Ainv, w1, b1, w2, b2, K: int, groups: int = 8,
    approximate: bool = True,
) -> torch.Tensor:
    """Plain version of the kernel. Every product takes operands rounded to
    x's dtype and accumulates in f32; xn, z, the hidden layer and o are
    rounded where the kernel rounds them; the residual adds the f32 xn."""
    cd = x.dtype
    B, HW, C = x.shape
    nb = w1.shape[1]
    bs = C // nb

    def rnd(t):
        return t.to(cd).float()

    xn32 = group_norm(x.float(), gscale, gbias, groups)
    z = rnd(torch.matmul(A.float(), rnd(xn32)))                   # (B, 2K, C)
    zj = torch.cat(
        [z[:, :K].reshape(B, K, nb, bs), z[:, K:].reshape(B, K, nb, bs)], dim=-1
    )                                                              # (B, K, nb, 2bs)
    W1 = rnd(complex_as_real_weight(w1[0], w1[1]))
    W2 = rnd(complex_as_real_weight(w2[0], w2[1]))
    B1 = torch.cat([b1[0], b1[1]], dim=-1)
    B2 = torch.cat([b2[0], b2[1]], dim=-1)
    h = torch.einsum("bkji,jio->bkjo", zj, W1) + B1
    h = rnd(F.gelu(h, approximate="tanh" if approximate else "none"))
    o = torch.einsum("bkji,jio->bkjo", h, W2) + B2
    ob = rnd(
        torch.cat([o[..., :bs].reshape(B, K, C), o[..., bs:].reshape(B, K, C)], dim=1)
    )
    y = torch.matmul(Ainv.float(), ob)
    return (y + xn32).to(x.dtype)


def _check(x, gscale, gbias, A, Ainv, w1, b1, w2, b2, K, groups):
    if x.dim() != 3:
        raise ValueError(f"x must be (B, HW, C), got {tuple(x.shape)}")
    B, HW, C = x.shape
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be bfloat16 or float32, got {x.dtype}")
    if w1.dim() != 4 or w1.shape[0] != 2:
        raise ValueError(f"w1 must be (2, nb, bs, bs), got {tuple(w1.shape)}")
    nb = w1.shape[1]
    if C % nb:
        raise ValueError(f"C={C} is not divisible by nb={nb}")
    bs = C // nb
    if tuple(w1.shape) != (2, nb, bs, bs) or tuple(w2.shape) != (2, nb, bs, bs):
        raise ValueError(
            f"w1 {tuple(w1.shape)} / w2 {tuple(w2.shape)} must be {(2, nb, bs, bs)}: "
            "the fused kernel needs hidden_size_factor == 1"
        )
    if groups <= 0 or C % groups:
        raise ValueError(f"C={C} is not divisible by groups={groups}")
    if HW > COMBINED_MAX_PIXELS:
        raise NotImplementedError(
            f"latent of {HW} px exceeds {COMBINED_MAX_PIXELS}: the separable DFT "
            "branch is not ported yet (ROADMAP, 'Modules to port')"
        )
    shapes = {
        "gscale": (gscale, (C,), torch.float32),
        "gbias": (gbias, (C,), torch.float32),
        "A": (A, (2 * K, HW), x.dtype),
        "Ainv": (Ainv, (HW, 2 * K), x.dtype),
        "w1": (w1, (2, nb, bs, bs), torch.float32),
        "b1": (b1, (2, nb, bs), torch.float32),
        "w2": (w2, (2, nb, bs, bs), torch.float32),
        "b2": (b2, (2, nb, bs), torch.float32),
    }
    for name, (t, shape, dtype) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


@functools.cache
def _kernel_fn():
    from dpot_tpu_torch.ops.cuda.build import load_library

    fn = load_library("afno_fused").dpot_fused_gn_afno
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, i] + [p] * 14 + [i] * 6 + [p]
    fn.restype = i
    return fn


def fused_gn_afno(
    x: torch.Tensor,
    gscale: torch.Tensor,
    gbias: torch.Tensor,
    A: torch.Tensor,
    Ainv: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    K: int,
    groups: int = 8,
    approximate: bool = True,
) -> torch.Tensor:
    """GroupNorm(groups) + AFNO mixer with its internal residual.

    x: (B, HW, C) bf16 or f32, the operand type; A (2K, HW) and Ainv
    (HW, 2K) of that type; gscale/gbias (C,) f32; w1/w2 (2, nb, bs, bs) and
    b1/b2 (2, nb, bs) f32 in the reference layout. approximate selects
    tanh-GELU (the TPU kernel) or erf-GELU (the JAX f32 path). Returns
    (B, HW, C) of x's dtype."""
    args = (x, gscale, gbias, A, Ainv, w1, b1, w2, b2)
    _check(*args, K, groups)
    if x.device.type == "cpu":
        return fused_gn_afno_ref(*args, K, groups, approximate)
    if x.device.type != "cuda":
        raise ValueError(f"fused_gn_afno runs on cuda or cpu, not {x.device}")
    B, HW, C = x.shape
    nb = w1.shape[1]
    # The scratch is freed on return, before the kernels have run; the caching
    # allocator hands it out again only to later work on this same stream.
    stats = torch.empty(B * groups * 2, device=x.device, dtype=torch.float32)
    z = torch.empty((B, 2 * K, C), device=x.device, dtype=x.dtype)
    h = torch.empty((B * K, nb, 2 * (C // nb)), device=x.device, dtype=x.dtype)
    o = torch.empty_like(z)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _kernel_fn()(
            int(x.dtype == torch.bfloat16), int(approximate),
            *(t.data_ptr() for t in (*args, stats, z, h, o, out)),
            B, HW, C, K, nb, groups,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_gn_afno kernel launch failed: CUDA error {err}")
    fused_gn_afno.launches += 1
    return out


fused_gn_afno.launches = 0
