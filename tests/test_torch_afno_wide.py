"""The shape gate of the bf16 kernel for AFNO blocks of 256 channels
(dpot_tpu_torch/csrc/afno_hopper_wide.cu) and the path choice of the fused
op between the four kernels. The kernel itself runs only on the card
(tests/test_torch_gpu.py, chip_smoke.py); what is checked here is the
Python that decides, before any launch and from shapes alone, which kernel
a call takes, and the shared-memory plan that the source states.
"""

import re

import pytest
import torch

from dpot_tpu_torch.ops.cuda import build
from dpot_tpu_torch.ops.cuda.afno_fused import (
    hopper_f32_supported,
    hopper_stream_supported,
    hopper_supported,
    hopper_wide_supported,
    kernel_path,
)
from test_torch_afno_hopper import preset_shapes

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("B", [1, 8, 20])
def test_dpot_h_takes_the_wide_kernel(B):
    """DPOT-H at 128^2, patch 8: a 256-px latent, K = 144 modes, 8 AFNO
    blocks of 256 channels and GroupNorm(8), one group per block."""
    shapes = preset_shapes("H", B)
    _, HW, C, K, nb, groups = shapes
    assert (HW, K, C // nb, C // groups) == (256, 144, 256, 256)
    assert hopper_wide_supported(*shapes, BF16)
    assert kernel_path(*shapes, BF16) == "hopper_wide"


@pytest.mark.parametrize("name", ["Ti", "S", "M"])
@pytest.mark.parametrize("B", [1, 8, 20])
def test_blocks_of_128_still_take_the_hopper_kernel(name, B):
    shapes = preset_shapes(name, B)
    assert not hopper_wide_supported(*shapes, BF16)
    assert kernel_path(*shapes, BF16) == "hopper"


@pytest.mark.parametrize("name,dtype", [("L", BF16), ("L", F32), ("H", F32)])
def test_l_and_f32_h_keep_the_general_kernel(name, dtype):
    """L (blocks of 96 channels) takes the kernel for 96-channel blocks of
    its type (hopper_l, hopper_f32_l); f32 at H (blocks of 256) takes the
    f32 kernel for 256-channel blocks (hopper_f32_wide), no longer the
    five-launch one. Neither takes the bf16 wide or the 128-channel
    kernels."""
    shapes = preset_shapes(name)
    assert not hopper_wide_supported(*shapes, dtype)
    assert not hopper_supported(*shapes, dtype) and not hopper_f32_supported(*shapes, dtype)
    want = {"L": {BF16: "hopper_l", F32: "hopper_f32_l"},
            "H": {F32: "hopper_f32_wide"}}[name][dtype]
    assert kernel_path(*shapes, dtype) == want


# each kind of shape the wide gate admits besides H, as
# tests/test_torch_gpu.py runs the kernel on the card: (B, HW, C, K, nb, groups)
ADMITTED_WIDE_EDGES = [
    (2, 128, 2048, 40, 8, 8),    # 16x8 latent, modes 8: one short mode chunk
    (2, 128, 2048, 80, 8, 8),    # 16x8 latent, modes 16: a partial second chunk
    (2, 256, 2048, 160, 8, 8),   # 32x8 latent, modes 32: 2K = 320, the most
    (2, 256, 2048, 4, 8, 8),     # modes 2: 2K = 8
    (2, 256, 2048, 144, 8, 16),  # groups of 128 channels, two per block
    (2, 256, 2048, 144, 8, 256), # groups of 8
    (2, 256, 256, 144, 1, 1),    # one AFNO block, one group
    (2, 256, 512, 144, 2, 2),    # two blocks, a group each
]


@pytest.mark.parametrize("shapes", ADMITTED_WIDE_EDGES)
def test_admitted_wide_edge_shapes(shapes):
    assert hopper_wide_supported(*shapes, BF16)
    assert kernel_path(*shapes, BF16) == "hopper_wide"


@pytest.mark.parametrize("shapes", [
    (1, 256, 2048, 144, 8, 4),    # groups of 512 channels straddle AFNO blocks
    (1, 256, 2048, 144, 8, 512),  # groups of 4 channels
    (1, 256, 2048, 144, 8, 24),   # groups of 85.3 channels: C % groups
    (1, 256, 1536, 144, 16, 8),   # blocks of 96 (L)
    (1, 256, 2048, 144, 4, 8),    # blocks of 512
    (1, 512, 2048, 144, 8, 8),    # a 512-px latent: the slab does not fit
    (1, 64, 2048, 16, 8, 8),      # a 64-px latent: no 128-px synthesis tile
    (1, 256, 2048, 142, 8, 8),    # K not a multiple of 4
    (1, 256, 2048, 164, 8, 8),    # 2K = 328: o does not fit the synthesis CTA
    (0, 256, 2048, 144, 8, 8),    # empty batch
    (65536, 256, 2048, 144, 8, 8),  # a batch beyond the grid's z dimension
])
def test_ragged_and_unfit_wide_shapes_are_refused(shapes):
    """Refused by the wide gate: the streamed kernel where its gate admits
    them (the latents up to 4096 px the bf16 kernels' rule refuses), else
    the five-launch kernel, but for L's blocks of 96
    channels, which take their own kernel (tests/test_torch_afno_l.py)."""
    assert not hopper_wide_supported(*shapes, BF16)
    stream = hopper_stream_supported(*shapes, BF16)
    assert kernel_path(*shapes, BF16) == (
        "hopper_l" if shapes[2] == 1536 else "hopper_stream" if stream else "general")


def test_f32_never_takes_the_wide_kernel():
    for shapes in ADMITTED_WIDE_EDGES:
        assert not hopper_wide_supported(*shapes, F32)
        assert kernel_path(*shapes, F32) != "hopper_wide"


def _constants() -> dict[str, int]:
    """The shared-memory plan of afno_hopper_wide.cu, read from its source:
    every `constexpr int NAME = <integer>;`."""
    src = (build.SRC_DIR / "afno_hopper_wide.cu").read_text()
    return {m[1]: int(m[2]) for m in re.finditer(r"constexpr int (\w+) = (\d+);", src)}


def test_shared_memory_plan_fits_a_cta():
    """The tile arithmetic of the kernel's design, mirrored here: at the
    largest admitted latent (256 px) the x slab (4 quarters of HW x 64 bf16)
    and the A rows of 64 modes (re and im, HW wide) sit below ring slot 0;
    z/h (64 modes x 512 bf16) and ring slots 1-4 (32 KB weight tiles) lie in
    the bytes they leave, without overlapping each other or slot 0; the
    barriers, reduction scratch and statistics follow; the whole stays
    within the 227 KB (232,448 bytes) a CTA may have."""
    c = _constants()
    hw, bs, modes, tile, slots = 256, c["BS"], c["MODES"], c["W_TILE"], c["SLOTS"]
    assert bs == 256 and modes == 64 and tile == bs * 64 * 2 and slots == 5
    assert c["STAGES"] == 2 * 2 * (bs // 64)
    slab = 4 * hw * 64 * 2
    a_rows = 2 * (hw // 64) * modes * 64 * 2
    zh = 8 * modes * 64 * 2
    assert c["S_X"] + slab <= c["S_A"]
    assert c["S_A"] + a_rows <= c["S_SLOT0"]
    slot = [c["S_SLOT0"]] + [65536 + (i - 1) * tile for i in range(1, slots)]
    spans = sorted([(c["S_ZH"], c["S_ZH"] + zh)] + [(s, s + tile) for s in slot])
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= c["S_MISC"]
    barriers, red, stats = 2 * (1 + slots) * 8, 8 * 32 * 4, 2 * 32 * 4
    assert 128 + red + stats <= 1536 and barriers <= 128
    smem = c["S_MISC"] + 1536 + 1024  # SPECTRAL_SMEM: + alignment slack
    assert smem <= 232448
    # the registers a consumer thread holds for one m64 x n256 f32
    # accumulator, within the 224 a thread of 288 may have
    assert 64 * bs // 128 == 128 <= 65536 // (256 + 32) // 8 * 8
