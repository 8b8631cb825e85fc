"""The shape gates of the two kernels for AFNO blocks of 96 channels
(dpot_tpu_torch/csrc/afno_hopper_l.cu in bf16, afno_hopper_f32_l.cu in f32),
the path choice of the fused op between its six kernels, and the
shared-memory plans that the sources state. The kernels themselves run only
on the card (tests/test_torch_gpu.py, chip_smoke.py); what is checked here
is the Python that decides, before any launch and from shapes alone, which
kernel a call takes.
"""

import re

import pytest
import torch

from dpot_tpu_torch.models import MODEL_PRESETS
from dpot_tpu_torch.ops.cuda import afno_fused, build
from dpot_tpu_torch.ops.cuda.afno_fused import (
    hopper_f32_l_supported,
    hopper_l_supported,
    hopper_stream_supported,
    kernel_path,
)
from test_torch_afno_hopper import preset_shapes

BF16, F32 = torch.bfloat16, torch.float32
GATES = {BF16: (hopper_l_supported, "hopper_l"), F32: (hopper_f32_l_supported, "hopper_f32_l")}


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("B", [1, 8, 20])
def test_dpot_l_takes_the_kernels_for_96_channel_blocks(dtype, B):
    """DPOT-L at 128^2, patch 8: a 256-px latent, K = 144 modes, 16 AFNO
    blocks of 96 channels and GroupNorm(8), groups of 192 spanning two
    blocks."""
    shapes = preset_shapes("L", B)
    _, HW, C, K, nb, groups = shapes
    assert (HW, K, C // nb, C // groups) == (256, 144, 96, 192)
    gate, path = GATES[dtype]
    assert gate(*shapes, dtype)
    assert kernel_path(*shapes, dtype) == path


@pytest.mark.parametrize("name", ["Ti", "S", "M", "H"])
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_other_presets_keep_their_kernels(name, dtype):
    """Ti, S and M keep hopper / hopper_f32, H hopper_wide in bf16 and
    hopper_f32_wide in f32."""
    shapes = preset_shapes(name)
    assert not hopper_l_supported(*shapes, dtype) and not hopper_f32_l_supported(*shapes, dtype)
    want = {"H": {BF16: "hopper_wide", F32: "hopper_f32_wide"}}.get(
        name, {BF16: "hopper", F32: "hopper_f32"})[dtype]
    assert kernel_path(*shapes, dtype) == want


# each kind of shape the gates admit besides L, as tests/test_torch_gpu.py
# runs the kernels on the card: (B, HW, C, K, nb, groups)
ADMITTED_L_EDGES = {
    BF16: [
        (2, 256, 384, 144, 4, 4),    # a group per block
        (2, 256, 384, 144, 4, 2),    # a group per block pair
        (2, 256, 1536, 144, 16, 16), # L's width, a group per block
        (2, 128, 1536, 40, 16, 8),   # 16x8 latent, modes 8: one short mode chunk
        (2, 256, 1536, 160, 16, 8),  # 32x8 latent, modes 32: 2K = 320, the most
        (2, 256, 1536, 4, 16, 8),    # modes 2: 2K = 8
    ],
    F32: [
        (2, 256, 192, 144, 2, 1),    # one block pair, C 192
        (2, 256, 384, 144, 4, 4),    # a group per block
        (2, 256, 1536, 144, 16, 16), # L's width, a group per block
        (2, 128, 1536, 80, 16, 8),   # 16x8 latent, modes 16: a partial mode chunk
        (2, 64, 1536, 16, 16, 8),    # 8x8 latent: one synthesis pixel tile
        (2, 1024, 384, 144, 4, 2),   # 32x32 latent: 32 pixel chunks
        (2, 256, 1536, 4, 16, 8),    # modes 2: 2K = 8
        (2, 256, 1536, 143, 16, 8),  # K odd: Ainv's rows padded to 16-byte units
        (2, 96, 1536, 40, 16, 8),    # 96 px: padded to whole 64-px tiles
    ],
}


@pytest.mark.parametrize("dtype,shapes", [(dt, s) for dt, ss in ADMITTED_L_EDGES.items()
                                          for s in ss])
def test_admitted_l_edge_shapes(dtype, shapes):
    gate, path = GATES[dtype]
    assert gate(*shapes, dtype)
    assert kernel_path(*shapes, dtype) == path


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("shapes", [
    (2, 256, 1536, 144, 16, 4),     # groups of 384 channels straddle four blocks
    (2, 256, 576, 144, 6, 2),       # groups of 288 channels straddle three blocks
    (2, 256, 1536, 144, 16, 32),    # groups of 48 channels, two per block
    (2, 256, 1536, 144, 16, 64),    # groups of 24
    (2, 256, 1536, 144, 8, 8),      # blocks of 192
    (2, 256, 1536, 144, 12, 8),     # blocks of 128 (S-like width at C 1536)
    (2, 256, 96, 144, 1, 1),        # one block: C 96 fits no synthesis tile
    (2, 256, 288, 144, 3, 3),       # three blocks: C 288 fits no synthesis tile
    (0, 256, 1536, 144, 16, 8),     # empty batch
    (65536, 256, 1536, 144, 16, 8), # a batch beyond the grid's z dimension
    (2, 8192, 1536, 144, 16, 8),    # above the combined-operator DFT's limit
])
def test_ragged_and_unfit_l_shapes_are_refused(dtype, shapes):
    gate, _ = GATES[dtype]
    assert not gate(*shapes, dtype)
    assert kernel_path(*shapes, dtype) not in ("hopper_l", "hopper_f32_l")


@pytest.mark.parametrize("shapes", [
    (2, 256, 192, 144, 2, 1),       # C 192: not whole 128-channel synthesis tiles
    (2, 256, 1536, 164, 16, 8),     # 2K = 328: o does not fit the synthesis CTA
    (2, 256, 1536, 142, 16, 8),     # K not a multiple of 4
    (2, 512, 1536, 144, 16, 8),     # a 512-px latent: the slab does not fit
    (2, 64, 1536, 16, 16, 8),       # a 64-px latent: no 128-px synthesis tile
    (2, 256, 1536, 143, 16, 8),     # K odd
    (2, 96, 1536, 40, 16, 8),       # 96 px: no whole 128-px tiles
])
def test_bf16_l_gate_refuses_what_only_f32_takes(shapes):
    """Shapes the f32 kernel takes (a 64-channel synthesis tile, any latent
    up to 4096 px, any K) and the bf16 one does not. In bf16 the
    streamed kernel takes those whose latent the bf16 kernels' rule refuses
    (all but C 192 at a 256-px latent, which goes to the five-launch
    kernel)."""
    assert not hopper_l_supported(*shapes, BF16)
    assert hopper_f32_l_supported(*shapes, F32)
    want = "general" if shapes[2] == 192 else "hopper_stream"
    assert hopper_stream_supported(*shapes, BF16) == (want == "hopper_stream")
    assert kernel_path(*shapes, BF16) == want


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_each_gate_refuses_the_other_type(dtype):
    other = F32 if dtype == BF16 else BF16
    gate, _ = GATES[dtype]
    for shapes in ADMITTED_L_EDGES[dtype] + [preset_shapes("L", 8)]:
        assert not gate(*shapes, other)
        assert kernel_path(*shapes, other) != GATES[dtype][1]


def test_l_gates_are_pure_functions_of_shapes():
    """Same answer for the same shapes, whatever was asked before."""
    asks = [(*preset_shapes(n, B), dt) for n in MODEL_PRESETS for B in (1, 7)
            for dt in (F32, BF16)]
    for gate in (hopper_l_supported, hopper_f32_l_supported):
        a = [gate(*s) for s in asks]
        b = [gate(*s) for s in reversed(asks)][::-1]
        assert a == b
        assert sum(a) == 2  # L at B 1 and 7, in the gate's own type


def test_the_launch_counts_know_every_path():
    assert tuple(afno_fused.fused_gn_afno.launches_by_path) == afno_fused.PATHS
    assert {"hopper_l", "hopper_f32_l", "general"} <= set(afno_fused.PATHS)


def _constants(name: str) -> dict[str, int]:
    """The namespace-level `constexpr int NAME = <expression>;` of a kernel
    source, in order, each evaluated with integer division over the ones
    before (an f32 file sees afno_hopper_f32.cu's, which it includes)."""
    src = (build.SRC_DIR / name).read_text()
    if '#include "afno_hopper_f32.cu"' in src:
        src = (build.SRC_DIR / "afno_hopper_f32.cu").read_text() + src
    out: dict[str, int] = {}
    for m in re.finditer(r"^constexpr int (\w+) = ([^;]+);", src, re.MULTILINE):
        out[m[1]] = eval(m[2].replace("/", "//"), {}, dict(out))
    return out


def test_bf16_shared_memory_plan_fits_a_cta():
    """The tile arithmetic of afno_hopper_l.cu's design, mirrored here: at
    the largest admitted latent (256 px) the x slab (two 64-channel boxes of
    HW rows: the block's 96 channels and the next 32), the A rows of 64
    modes (re and im), W1 (two [96 out][64 in] boxes per part) and z/h (64
    modes x 192 columns, three 64-column k-blocks) sit one after another,
    each at a 1024-byte swizzle atom; W2 fits in the slab's bytes; the
    barriers and reduction scratch follow; the whole stays within the
    227 KB (232,448 bytes) a CTA may have. As the issue's plan: x 64 KB
    (48 KB of it the block's), A 64 KB, W1 48 KB (36 KB of weights), z/h
    24 KB."""
    c = _constants("afno_hopper_l.cu")
    hw, bs, modes = c["MAX_HW"], c["BS"], c["MODES"]
    assert (hw, bs, modes, c["NT"]) == (256, 96, 64, 256)
    assert c["W_TILE"] == bs * 64 * 2
    slab = 2 * hw * 64 * 2
    a_rows = 2 * (hw // 64) * modes * 64 * 2
    w1 = 2 * 2 * c["W_TILE"]
    zh = 3 * modes * 64 * 2
    assert -(-2 * bs // 64) == 3  # [z_re | z_im] is three k-blocks
    spans = [(c["S_X"], slab), (c["S_A"], a_rows), (c["S_W1"], w1), (c["S_ZH"], zh)]
    for (a, n), (b, _) in zip(spans, spans[1:]):
        assert a + n <= b
    assert c["S_ZH"] + zh <= c["S_MISC"]
    assert all(off % 1024 == 0 for off, _ in spans) and c["W_TILE"] % 1024 == 0
    assert w1 <= slab  # W2 streams into the slab's bytes
    barriers, red = 7 * 8, 8 * 4
    assert 64 + red <= 1024 and barriers <= 64
    assert c["SPECTRAL_SMEM"] == c["S_MISC"] + 1024 + 1024 <= 232448
    # the registers a thread holds for the analysis' m64 x n128 and the MLP's
    # m64 x n96 accumulators, within the 255 a thread may have
    assert 64 * 128 // 128 + 64 * 96 // 128 == 112 <= 255
    # the group statistics deal whole 8-channel chunks evenly to the threads
    for hw_ in (128, 256):
        for cpg in (bs, 2 * bs):
            assert hw_ * cpg // 8 % c["NT"] == 0


def test_f32_shared_memory_plan_fits_two_ctas_an_sm():
    """afno_hopper_f32_l.cu's plan: 6 warps (re and im, each three 32-column
    warp tiles); padded strides with the bank residues of the 128-channel
    kernel (LDX 104 = 8, LDZ 196 = 4 mod 32); an x + A ring stage fits a
    weight stage; z/h, the per-channel columns and the reduction scratch
    follow; two CTAs fit an SM's 228 KB (each within its 227 KB); the
    statistics deal each thread a fixed 4-channel column of its group."""
    c = _constants("afno_hopper_f32_l.cu")
    assert c["BS"] == 96 and c["NT"] == 192 == 2 * (c["BS"] // 32) * 32
    assert c["LDX"] % 32 == 8 and c["LDZ"] % 32 == 4 and c["LDX"] % 4 == 0
    assert c["KC"] * c["LDX"] + 2 * c["MAX_MC"] * c["LDA"] <= c["STAGE"]
    assert c["F_Z"] == 2 * c["STAGE"]
    assert c["F_COL"] == c["F_Z"] + c["MAX_MC"] * c["LDZ"]
    assert c["F_RED"] == c["F_COL"] + 3 * c["BS"]
    assert c["SPECTRAL_SMEM"] == (c["F_RED"] + 32) * 4
    assert 2 * (c["SPECTRAL_SMEM"] + 1024) <= 233472 and c["SPECTRAL_SMEM"] <= 232448
    assert c["BS"] % c["KC"] == 0  # whole 32-row weight chunks
    for cpg in (c["BS"], 2 * c["BS"]):
        cols = cpg // 4
        assert c["NT"] % cols == 0 and c["TC"] % (c["NT"] // cols) == 0
