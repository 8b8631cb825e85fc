"""The f32 Hopper kernel of fused_gn_afno (dpot_tpu_torch/csrc/afno_hopper_f32.cu)
on the CPU: its shape gate and the path choice, the TF32 split it applies to
every operand, why it splits (3xTF32 meets the f32 tolerance where
single-pass TF32 does not), and the plain version it is held against, at a
shape the gate admits, against the JAX package. The kernel itself runs only
on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import math

import numpy as np
import pytest
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from dpot_tpu_torch.models import MODEL_PRESETS
from dpot_tpu_torch.ops.cuda.afno_fused import (
    fused_gn_afno,
    fused_gn_afno_ref,
    hopper_f32_supported,
    kernel_path,
    tf32_split,
)
from dpot_tpu_torch.ops.norms import group_norm
from dpot_tpu_torch.ops.spectral import (
    combined_spectral_ops,
    complex_as_real_weight,
    kept_modes,
)

BF16, F32 = torch.bfloat16, torch.float32
# the f32 kernel against its plain version, as chip_smoke.py's TOL[float32]
TOL = dict(max_abs=5e-5, rel_l2=1e-5)


def preset_shapes(name: str, B: int = 1, res: int = 128, patch: int = 8, modes: int = 32):
    """(B, HW, C, K, nb, groups) of one trunk block of a preset at res^2."""
    p = MODEL_PRESETS[name]
    h = res // patch
    kh, kw = kept_modes(h, h, modes)
    return B, h * h, p["embed_dim"], kh * kw, p["n_blocks"], 8


@pytest.mark.parametrize("name", ["Ti", "S", "M"])
@pytest.mark.parametrize("B", [1, 8, 20])
def test_f32_gate_admits_presets_with_128_channel_blocks(name, B):
    shapes = preset_shapes(name, B)
    assert hopper_f32_supported(*shapes, F32)
    assert kernel_path(*shapes, F32) == "hopper_f32"


# each kind of shape the f32 gate admits besides Ti, as tests/test_torch_gpu.py
# runs the kernel on the card: (B, HW, C, K, nb, groups)
ADMITTED_F32_EDGES = [
    (2, 256, 1024, 144, 8, 8),    # S/M width: groups of 128 channels
    (2, 128, 512, 40, 4, 8),      # 16x8 latent, modes 8: one partial mode chunk
    (2, 128, 512, 80, 4, 8),      # 16x8 latent, modes 16: a partial third chunk
    (2, 256, 512, 160, 4, 8),     # 32x8 latent, modes 32: five whole chunks
    (2, 256, 512, 4, 4, 8),       # modes 2: 2K = 8, one partial synthesis stage
    (2, 64, 512, 16, 4, 8),       # 8x8 latent, modes 4: one synthesis pixel tile
    (2, 1024, 512, 144, 4, 8),    # 32x32 latent, modes 12: 32 pixel chunks
    (2, 256, 512, 144, 4, 4),     # groups of 128 channels at Ti
    (2, 256, 512, 144, 4, 16),    # groups of 32
    (2, 256, 512, 144, 4, 64),    # groups of 8
    (2, 256, 128, 144, 1, 8),     # one AFNO block
    (2, 256, 1024, 144, 8, 128),  # S/M width, groups of 8
    (1, 96, 512, 40, 4, 8),       # 12x8 latent: 96 px, padded to 128
    (1, 32, 512, 10, 4, 8),       # 32 px: below one synthesis tile, padded to one
    (1, 256, 512, 9, 4, 8),       # K odd: Ainv's rows padded to 16-byte units
    (1, 256, 512, 143, 4, 8),     # K odd
]


@pytest.mark.parametrize("shapes", ADMITTED_F32_EDGES)
def test_f32_gate_admits_edge_shapes(shapes):
    assert hopper_f32_supported(*shapes, F32)
    assert kernel_path(*shapes, F32) == "hopper_f32"


@pytest.mark.parametrize("name", ["L", "H"])
def test_f32_gate_refuses_other_block_sizes(name):
    """L (blocks of 96 channels) takes the f32 kernel for 96-channel blocks
    (afno_hopper_f32_l.cu); H (256) the f32 kernel for 256-channel blocks
    (afno_hopper_f32_wide.cu)."""
    shapes = preset_shapes(name)
    assert not hopper_f32_supported(*shapes, F32)
    assert kernel_path(*shapes, F32) == ("hopper_f32_l" if name == "L" else "hopper_f32_wide")


@pytest.mark.parametrize("shapes", [
    (3, 64, 96, 9, 4, 8),        # 8x8 latent, modes 3: bs 24
    (3, 48, 40, 15, 2, 4),       # 4x12 latent, modes 5: bs 20
    (1, 8192, 512, 144, 4, 8),   # above the combined-operator DFT's limit
    (1, 256, 512, 144, 4, 2),    # groups of 256 channels straddle AFNO blocks
    (1, 256, 512, 144, 4, 128),  # groups of 4 channels
    (0, 256, 512, 144, 4, 8),    # empty batch
])
def test_f32_gate_refuses_ragged_and_unfit_shapes(shapes):
    assert not hopper_f32_supported(*shapes, F32)
    assert kernel_path(*shapes, F32) == "general"


@pytest.mark.parametrize("name", ["Ti", "S", "M"])
def test_f32_gate_refuses_bf16(name):
    """bf16 at these shapes is the bf16 Hopper kernel's, never the f32 one's."""
    shapes = preset_shapes(name)
    assert not hopper_f32_supported(*shapes, BF16)
    assert kernel_path(*shapes, BF16) == "hopper"


def test_f32_gate_is_a_pure_function_of_shapes():
    """Same answer for the same shapes, whatever was asked before."""
    asks = [(*preset_shapes(n, B), dt) for n in MODEL_PRESETS for B in (1, 7)
            for dt in (F32, BF16)]
    a = [hopper_f32_supported(*s) for s in asks]
    b = [hopper_f32_supported(*s) for s in reversed(asks)][::-1]
    assert a == b == [n in ("Ti", "S", "M") and dt == F32
                      for n in MODEL_PRESETS for _ in (1, 7) for dt in (F32, BF16)]


def _low13(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) & 0x1FFF


def test_tf32_split_parts_are_tf32_and_sum_to_the_value():
    """hi and lo keep 10 explicit mantissa bits (the low 13 bits are zero);
    hi + lo equals a to 2^-22 relative: hi takes 11 significant bits, lo the
    next 11, rounded to nearest."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(
        (rng.standard_normal(100_000) * 10.0 ** rng.uniform(-6, 6, 100_000)).astype(np.float32))
    hi, lo = tf32_split(a)
    assert hi.dtype == lo.dtype == F32
    assert (_low13(hi) == 0).all() and (_low13(lo) == 0).all()
    rel = ((hi.double() + lo.double()) - a.double()).abs() / a.double().abs()
    assert rel.max().item() <= 2.0 ** -22
    # hi alone is single-pass TF32: about 2^-11 relative, far coarser
    assert ((hi.double() - a.double()).abs() / a.double().abs()).max().item() > 2.0 ** -13


def test_tf32_split_rounds_to_nearest_ties_away_from_zero():
    """cvt.rna: a value halfway between two TF32 values goes away from 0."""
    one_ulp = 2.0 ** -10
    vals = torch.tensor([1.0 + one_ulp / 2, -(1.0 + one_ulp / 2), 1.0 + one_ulp / 4,
                         1.0 + 3 * one_ulp / 4, 0.0, -2.5], dtype=F32)
    hi, lo = tf32_split(vals)
    want = torch.tensor([1.0 + one_ulp, -(1.0 + one_ulp), 1.0, 1.0 + one_ulp, 0.0, -2.5],
                        dtype=F32)
    torch.testing.assert_close(hi, want, rtol=0, atol=0)
    torch.testing.assert_close(hi + lo, vals, rtol=0, atol=0)


def _product(eq: str, a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """einsum(eq, a, b) as the tensor cores compute it from TF32 operands
    (exact products, summed here in f64): "tf32" is hi.hi' alone, "3xtf32"
    lo.hi' + hi.lo' + hi.hi', the kernel's."""
    (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)

    def d(p, q):
        return torch.einsum(eq, p.double(), q.double())

    if mode == "tf32":
        return d(ah, bh).float()
    return (d(al, bh) + d(ah, bl) + d(ah, bh)).float()


def _emulated_forward(x, gs, gb, A, Ainv, w1, b1, w2, b2, K, groups, mode):
    """fused_gn_afno_ref's f32 arithmetic (erf-GELU) with every product
    taken as `_product` takes it."""
    B, HW, C = x.shape
    nb = w1.shape[1]
    bs = C // nb
    xn = group_norm(x, gs, gb, groups)
    z = _product("kp,bpc->bkc", A, xn, mode)
    zj = torch.cat([z[:, :K].reshape(B, K, nb, bs), z[:, K:].reshape(B, K, nb, bs)], -1)
    W1 = complex_as_real_weight(w1[0], w1[1])
    W2 = complex_as_real_weight(w2[0], w2[1])
    h = F.gelu(_product("bkji,jio->bkjo", zj, W1, mode) + torch.cat([b1[0], b1[1]], -1))
    o = _product("bkji,jio->bkjo", h, W2, mode) + torch.cat([b2[0], b2[1]], -1)
    o = torch.cat([o[..., :bs].reshape(B, K, C), o[..., bs:].reshape(B, K, C)], 1)
    return _product("pk,bkc->bpc", Ainv, o, mode) + xn


def _seeded_args(B, H, W, C, nb, modes, groups, seed, scale=0.05):
    bs = C // nb
    kh, kw = kept_modes(H, W, modes)
    rng = np.random.default_rng(seed)

    def t(shape, s=1.0, shift=0.0):
        return torch.from_numpy((shift + s * rng.standard_normal(shape)).astype(np.float32))

    A, Ainv = combined_spectral_ops(H, W, kh, kw, F32, torch.device("cpu"))
    return (t((B, H * W, C)), t((C,), 0.1, 1.0), t((C,), 0.1), A, Ainv,
            t((2, nb, bs, bs), scale), t((2, nb, bs), scale),
            t((2, nb, bs, bs), scale), t((2, nb, bs), scale), kh * kw, groups)


def test_3xtf32_meets_the_f32_tolerance_where_single_pass_tf32_does_not():
    """Why the kernel splits. At an admitted shape (16x16 latent, one AFNO
    block of 128 channels, modes 8, weights N(0, 0.05^2)) the kernel's
    arithmetic with 3xTF32 products stays within TOL (5e-5 absolute, 1e-5
    relative L2) of the f32 plain version; with single-pass TF32 products
    it misses both."""
    args = _seeded_args(2, 16, 16, 128, 1, 8, 8, seed=7)
    assert hopper_f32_supported(*[args[0].shape[0], 256, 128, args[9], 1, 8], F32)
    want = fused_gn_afno_ref(*args, approximate=False)
    errs = {}
    for mode in ("3xtf32", "tf32"):
        got = _emulated_forward(*args, mode)
        errs[mode] = ((got - want).abs().max().item(),
                      ((got - want).norm() / want.norm()).item())
    assert errs["3xtf32"][0] <= TOL["max_abs"] and errs["3xtf32"][1] <= TOL["rel_l2"], errs
    assert errs["tf32"][0] > TOL["max_abs"] and errs["tf32"][1] > TOL["rel_l2"], errs
    # and 3xTF32 is two orders of magnitude closer than single-pass TF32
    assert errs["3xtf32"][1] * 100 < errs["tf32"][1]


@pytest.mark.parametrize("shape", [
    dict(B=2, H=8, W=8, C=128, nb=1, modes=4, groups=8),   # 64 px, K 16
    dict(B=1, H=16, W=8, C=256, nb=2, modes=8, groups=16),  # 128 px, K 40
])
def test_plain_version_at_an_admitted_f32_shape_matches_jax(shape):
    """The yardstick of the f32 kernel, at shapes its gate admits, against
    the JAX f32 model path (group_norm, then afno_filter_2d with the
    residual of the normed input, erf-GELU). Tolerance 2e-5 absolute: f32
    throughout, another summation order."""
    from dpot_tpu.ops.activations import get_activation
    from dpot_tpu.ops.norms import group_norm as jax_group_norm
    from dpot_tpu.ops.spectral import afno_filter_2d

    B, H, W, C = shape["B"], shape["H"], shape["W"], shape["C"]
    args = _seeded_args(B, H, W, C, shape["nb"], shape["modes"], shape["groups"], seed=12,
                        scale=0.2)
    x, gs, gb, _, _, w1, b1, w2, b2, K, groups = args
    assert kernel_path(B, H * W, C, K, shape["nb"], groups, F32) == "hopper_f32"
    got = fused_gn_afno(*args, approximate=False).numpy()
    xn = jax_group_norm(jnp.asarray(x.numpy()).reshape(B, H, W, C), jnp.asarray(gs.numpy()),
                        jnp.asarray(gb.numpy()), groups)
    want = afno_filter_2d(xn, *(jnp.asarray(t.numpy()) for t in (w1, b1, w2, b2)),
                          shape["modes"], get_activation("gelu"), compute_dtype=jnp.float32)
    np.testing.assert_allclose(got, np.asarray(want).reshape(B, H * W, C), atol=2e-5, rtol=0)
    assert math.isfinite(float(np.abs(got).max()))
