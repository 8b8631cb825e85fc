"""The f32 kernel for AFNO blocks of 256 channels
(dpot_tpu_torch/csrc/afno_hopper_f32_wide.cu) on the CPU: its shape gate
and the path choice of the fused op between its seven kernels, the
shared-memory plan that the source states, why its products are 3xTF32 at
this block width, and the plain version it is held against, at shapes the
gate admits, against the JAX package. The kernel itself runs only on the
card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from dpot_tpu_torch.models import MODEL_PRESETS
from dpot_tpu_torch.ops.cuda import afno_fused, build
from dpot_tpu_torch.ops.cuda.afno_fused import (
    PATHS,
    fused_gn_afno,
    fused_gn_afno_ref,
    hopper_f32_wide_supported,
    hopper_stream_supported,
    hopper_wide_supported,
    kernel_path,
)
from test_torch_afno_f32 import TOL, _emulated_forward, _seeded_args
from test_torch_afno_hopper import preset_shapes
from test_torch_afno_l import _constants

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("B", [1, 8, 20])
def test_dpot_h_in_f32_takes_the_f32_wide_kernel(B):
    """DPOT-H at 128^2, patch 8: a 256-px latent, K = 144 modes, 8 AFNO
    blocks of 256 channels and GroupNorm(8), one group per block."""
    shapes = preset_shapes("H", B)
    _, HW, C, K, nb, groups = shapes
    assert (HW, K, C // nb, C // groups) == (256, 144, 256, 256)
    assert hopper_f32_wide_supported(*shapes, F32)
    assert kernel_path(*shapes, F32) == "hopper_f32_wide"


# each kind of shape the gate admits besides H, as tests/test_torch_gpu.py
# runs the kernel on the card: (B, HW, C, K, nb, groups)
ADMITTED_F32_WIDE_EDGES = [
    (2, 256, 1024, 144, 4, 4),    # a TP rank's share of H: 4 blocks, a group each
    (2, 256, 1024, 144, 4, 8),    # the same, groups of 128
    (2, 64, 2048, 16, 8, 8),      # 8x8 latent, modes 4: one synthesis pixel tile
    (2, 128, 2048, 80, 8, 8),     # 16x8 latent, modes 16: a partial mode chunk
    (2, 4096, 512, 144, 2, 2),    # 64x64 latent, modes 12: 128 pixel chunks
    (2, 256, 2048, 4, 8, 8),      # modes 2: 2K = 8
    (2, 256, 2048, 144, 8, 16),   # groups of 128 channels, two per block
    (2, 256, 2048, 144, 8, 256),  # groups of 8
    (2, 256, 256, 144, 1, 1),     # one AFNO block, one group
    (1, 256, 2048, 143, 8, 8),    # K odd: Ainv's rows padded to 16-byte units
    (1, 256, 2048, 9, 8, 8),      # K odd
    (1, 96, 2048, 40, 8, 8),      # 96 px: padded to whole 64-px tiles
    (1, 32, 2048, 10, 8, 8),      # 32 px: below one synthesis tile, padded to one
]


@pytest.mark.parametrize("shapes", ADMITTED_F32_WIDE_EDGES)
def test_admitted_f32_wide_edge_shapes(shapes):
    assert hopper_f32_wide_supported(*shapes, F32)
    assert kernel_path(*shapes, F32) == "hopper_f32_wide"


@pytest.mark.parametrize("shapes,why", [
    ((1, 256, 2048, 144, 4, 8), "blocks of 512 channels"),
    ((1, 256, 1536, 144, 16, 8), "blocks of 96 channels (L)"),
    ((1, 256, 1024, 144, 8, 8), "blocks of 128 channels (S)"),
    ((1, 256, 2048, 144, 8, 4), "groups of 512 channels straddle two blocks"),
    ((1, 256, 2048, 144, 8, 1), "one group over all eight blocks"),
    ((1, 256, 2048, 144, 8, 512), "groups of 4 channels"),
    ((1, 256, 2048, 144, 8, 24), "C % groups: groups of 85.3 channels"),
    ((1, 8192, 2048, 144, 8, 8), "above the combined-operator DFT's limit"),
    ((0, 256, 2048, 144, 8, 8), "empty batch"),
    ((65536, 256, 2048, 144, 8, 8), "a batch beyond the grid's z dimension"),
])
def test_f32_wide_gate_refuses_unfit_shapes(shapes, why):
    """Refused shapes go to the kernel of their own block width where one
    admits them (L, S), else to the five-launch kernel."""
    assert not hopper_f32_wide_supported(*shapes, F32), why
    assert kernel_path(*shapes, F32) != "hopper_f32_wide"
    assert kernel_path(*shapes, F32) in ("hopper_f32", "hopper_f32_l", "general")


@pytest.mark.parametrize("shapes", [preset_shapes("H", B) for B in (1, 8, 20)]
                         + ADMITTED_F32_WIDE_EDGES)
def test_f32_wide_gate_refuses_bf16(shapes):
    """bf16 at these shapes is the bf16 kernel for 256-channel blocks' where
    its gate admits it (a 128- or 256-px latent, K a multiple of 4 with 2K
    <= 320), else the streamed kernel's where its gate admits it, else the
    five-launch kernel's; never the f32 one's."""
    assert not hopper_f32_wide_supported(*shapes, BF16)
    want = ("hopper_wide" if hopper_wide_supported(*shapes, BF16)
            else "hopper_stream" if hopper_stream_supported(*shapes, BF16) else "general")
    assert kernel_path(*shapes, BF16) == want


def test_each_wide_gate_refuses_the_other_type():
    """hopper_wide_supported takes bf16 alone, hopper_f32_wide_supported f32
    alone, on H and on every edge of either."""
    from test_torch_afno_wide import ADMITTED_WIDE_EDGES

    for shapes in ADMITTED_WIDE_EDGES + ADMITTED_F32_WIDE_EDGES + [preset_shapes("H", 8)]:
        assert not hopper_wide_supported(*shapes, F32)
        assert not hopper_f32_wide_supported(*shapes, BF16)
        assert kernel_path(*shapes, F32) != "hopper_wide"
        assert kernel_path(*shapes, BF16) != "hopper_f32_wide"


def _asks() -> list[tuple]:
    """Every preset at two batches and a few other edges, in both types."""
    shapes = [preset_shapes(n, B) for n in MODEL_PRESETS for B in (1, 7)]
    shapes += ADMITTED_F32_WIDE_EDGES + [(3, 64, 96, 9, 4, 8), (2, 256, 384, 144, 4, 2)]
    return [(*s, dt) for s in shapes for dt in (F32, BF16)]


def test_gates_are_disjoint_pure_functions_of_shapes():
    """At most one gate admits any shape, the path is that gate's, and every
    gate gives the same answer for the same shapes whatever was asked
    before. H in f32 at both batches is the f32 wide gate's alone."""
    gates = dict(zip(PATHS, afno_fused._GATES))
    asks = _asks()
    for gate in gates.values():
        a = [gate(*s) for s in asks]
        b = [gate(*s) for s in reversed(asks)][::-1]
        assert a == b
    for s in asks:
        admitting = [p for p, gate in gates.items() if gate(*s)]
        assert len(admitting) <= 1, (s, admitting)
        assert kernel_path(*s) == (admitting[0] if admitting else "general")
    wide = [s for s in asks if hopper_f32_wide_supported(*s)]
    assert [s for s in wide if s[1:6] == (256, 2048, 144, 8, 8)] == [
        (*preset_shapes("H", B), F32) for B in (1, 7)]


def test_the_launch_counts_know_the_f32_wide_path():
    assert tuple(afno_fused.fused_gn_afno.launches_by_path) == afno_fused.PATHS
    assert PATHS.index("hopper_f32_wide") < PATHS.index("general") == len(PATHS) - 1
    assert len(afno_fused._GATES) == len(PATHS) - 1


def test_the_build_makes_a_library_of_the_new_source():
    """build.py compiles every csrc/*.cu into its own library, named for the
    source, so the path's ctypes lookup (library afno_<path>, function
    dpot_afno_<path>) finds it; the source is hashed with the others, so an
    edit to it or to the file it includes rebuilds every library."""
    paths = build.library_paths()
    assert "afno_hopper_f32_wide" in paths and "afno_hopper_f32" in paths
    assert paths["afno_hopper_f32_wide"].name.startswith("libafno_hopper_f32_wide-")
    digest = {p.name.split("-")[1] for p in paths.values()}
    assert len(digest) == 1
    src = (build.SRC_DIR / "afno_hopper_f32_wide.cu").read_text()
    assert 'extern "C" int dpot_afno_hopper_f32_wide(' in src
    assert 'extern "C" int dpot_afno_hopper_f32_wide_supported(' in src


def test_shared_memory_plan_fits_a_cta():
    """afno_hopper_f32_wide.cu's plan: 16 warps (re and im, each eight
    32-column warp tiles); padded strides with the bank residues of the
    128-channel kernel (LDX 264 = 8, LDZ 516 = 4 mod 32); an x + A ring
    stage fits a weight stage (2 x 32 x 264 floats); z/h at 32 modes (32 x
    516), the per-channel columns (3 x 256), the reduction scratch (one
    float a thread) and the group sums follow; the whole, 206,592 bytes,
    within the 227 KB (232,448 bytes) a CTA may have; the statistics pass
    deals each thread a fixed 4-channel column of whole rows."""
    c = _constants("afno_hopper_f32_wide.cu")
    assert c["BS"] == 256 and c["NT"] == 512 == 2 * (c["BS"] // 32) * 32
    assert (c["LDX"], c["LDZ"]) == (264, 516)
    assert c["LDX"] % 32 == 8 and c["LDZ"] % 32 == 4 and c["LDX"] % 4 == 0
    assert c["KC"] * c["LDX"] + 2 * c["MAX_MC"] * c["LDA"] <= c["STAGE"] == 2 * 32 * 264
    assert c["F_Z"] == 2 * c["STAGE"]
    assert c["F_COL"] == c["F_Z"] + c["MAX_MC"] * c["LDZ"]
    assert c["F_RED"] == c["F_COL"] + 3 * c["BS"]
    assert c["F_GRP"] == c["F_RED"] + c["NT"]
    assert c["SPECTRAL_SMEM"] == (c["F_GRP"] + 64) * 4 == 206592 <= 232448
    assert c["BS"] % c["KC"] == 0  # whole 32-row weight chunks
    assert c["NT"] % c["COLS"] == 0 and c["RSTEP"] == c["NT"] // c["COLS"] == 8
    assert 64 % c["RSTEP"] == 0  # every admitted latent is whole passes
    # a group of the statistics is 2 to 64 columns, at most 32 in a block
    assert c["BS"] // 8 <= 32 and c["BS"] // 4 == c["COLS"] == 64
    # the synthesis launch is the 128-channel kernel's: 64-channel tiles
    assert c["BS"] % c["TC"] == 0


def test_3xtf32_meets_the_f32_tolerance_at_256_channel_blocks():
    """Why the kernel splits, at its own block width: at an admitted shape
    (16x16 latent, one AFNO block of 256 channels, one group, modes 8,
    weights N(0, 0.05^2)) the kernel's arithmetic with 3xTF32 products
    stays within TOL (5e-5 absolute, 1e-5 relative L2) of the f32 plain
    version; with single-pass TF32 products it misses both."""
    args = _seeded_args(2, 16, 16, 256, 1, 8, 1, seed=9)
    assert hopper_f32_wide_supported(2, 256, 256, args[9], 1, 1, F32)
    want = fused_gn_afno_ref(*args, approximate=False)
    errs = {}
    for mode in ("3xtf32", "tf32"):
        got = _emulated_forward(*args, mode)
        errs[mode] = ((got - want).abs().max().item(),
                      ((got - want).norm() / want.norm()).item())
    assert errs["3xtf32"][0] <= TOL["max_abs"] and errs["3xtf32"][1] <= TOL["rel_l2"], errs
    assert errs["tf32"][0] > TOL["max_abs"] and errs["tf32"][1] > TOL["rel_l2"], errs
    assert errs["3xtf32"][1] * 100 < errs["tf32"][1]


@pytest.mark.parametrize("shape", [
    dict(B=2, H=8, W=8, C=512, nb=2, modes=4, groups=2),    # 64 px, K 16, a group a block
    dict(B=1, H=16, W=8, C=512, nb=2, modes=8, groups=4),   # 128 px, K 40, groups of 128
])
def test_plain_version_at_an_admitted_f32_wide_shape_matches_jax(shape):
    """The yardstick of the kernel, at shapes its gate admits, against the
    JAX f32 model path (group_norm, then afno_filter_2d with the residual
    of the normed input, erf-GELU). Tolerance 2e-5 absolute: f32
    throughout, another summation order. The weights are N(0, 0.1^2), so
    that a mode MLP layer's gain (0.1 sqrt(2 bs) = 2.3) is about that of
    test_torch_afno_f32.py's at 128 channels (0.2 sqrt(256) = 3.2) and the
    outputs have its magnitude. On the CPU the wrapper runs this plain
    version and launches nothing."""
    from dpot_tpu.ops.activations import get_activation
    from dpot_tpu.ops.norms import group_norm as jax_group_norm
    from dpot_tpu.ops.spectral import afno_filter_2d

    B, H, W, C = shape["B"], shape["H"], shape["W"], shape["C"]
    args = _seeded_args(B, H, W, C, shape["nb"], shape["modes"], shape["groups"], seed=13,
                        scale=0.1)
    x, gs, gb, _, _, w1, b1, w2, b2, K, groups = args
    assert kernel_path(B, H * W, C, K, shape["nb"], groups, F32) == "hopper_f32_wide"
    before = dict(fused_gn_afno.launches_by_path)
    got = fused_gn_afno(*args, approximate=False)
    assert fused_gn_afno.launches_by_path == before
    assert torch.equal(got, fused_gn_afno_ref(*args, approximate=False))
    xn = jax_group_norm(jnp.asarray(x.numpy()).reshape(B, H, W, C), jnp.asarray(gs.numpy()),
                        jnp.asarray(gb.numpy()), groups)
    want = afno_filter_2d(xn, *(jnp.asarray(t.numpy()) for t in (w1, b1, w2, b2)),
                          shape["modes"], get_activation("gelu"), compute_dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(B, H * W, C), atol=2e-5,
                               rtol=0)
    assert np.isfinite(got.numpy()).all()
