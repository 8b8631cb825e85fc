"""The shape gate of the bf16 Hopper kernel
(dpot_tpu_torch/csrc/afno_hopper.cu), the path choice of the fused op and
the cached bf16 weight blocks it reads. The kernel itself runs only on the
card (tests/test_torch_gpu.py, chip_smoke.py); what is checked here is the
Python that decides, before any launch and from shapes alone, which
kernel a call takes.
"""

import pytest
import torch

from dpot_tpu_torch.models import MODEL_PRESETS
from dpot_tpu_torch.ops.cuda import afno_fused
from dpot_tpu_torch.ops.cuda.afno_fused import (
    hopper_stream_supported,
    hopper_supported,
    kernel_path,
)
from dpot_tpu_torch.ops.spectral import kept_modes

BF16, F32 = torch.bfloat16, torch.float32


def preset_shapes(name: str, B: int = 1, res: int = 128, patch: int = 8, modes: int = 32):
    """(B, HW, C, K, nb, groups) of one trunk block of a preset at res^2,
    patch 8, modes 32 (GroupNorm(8), as the model builds it)."""
    p = MODEL_PRESETS[name]
    h = res // patch
    kh, kw = kept_modes(h, h, modes)
    return B, h * h, p["embed_dim"], kh * kw, p["n_blocks"], 8


@pytest.mark.parametrize("name", ["Ti", "S", "M"])
@pytest.mark.parametrize("B", [1, 8, 20])
def test_admitted_presets_and_their_plan(name, B):
    """Ti, S and M (AFNO blocks of 128 channels) take the Hopper kernel at
    128^2, patch 8: a 256-px latent and K = 144 modes, so 2K = 288 rows of
    o, five 64-row blocks, fit one synthesis CTA."""
    shapes = preset_shapes(name, B)
    assert hopper_supported(*shapes, BF16)
    assert kernel_path(*shapes, BF16) == "hopper"
    _, HW, C, K, nb, _ = shapes
    assert (HW, K, C // nb) == (256, 144, 128)


# each kind of shape the gate admits besides Ti, as tests/test_torch_gpu.py
# runs the kernel on the card: (B, HW, C, K, nb, groups)
ADMITTED_EDGES = [
    (2, 256, 1024, 144, 8, 8),   # S/M width: groups of 128 channels
    (2, 128, 512, 40, 4, 8),     # 16x8 latent, modes 8: one short mode chunk
    (2, 128, 512, 80, 4, 8),     # 16x8 latent, modes 16: a partial second chunk
    (2, 256, 512, 160, 4, 8),    # 32x8 latent, modes 32: 2K = 320, the most
    (2, 256, 512, 4, 4, 8),      # modes 2: 2K = 8
    (2, 256, 512, 144, 4, 4),    # groups of 128 channels at Ti
    (2, 256, 512, 144, 4, 16),   # groups of 32
    (2, 256, 512, 144, 4, 64),   # groups of 8
    (2, 256, 128, 144, 1, 8),    # one AFNO block
    (2, 256, 1024, 144, 8, 128), # S/M width, groups of 8
]


@pytest.mark.parametrize("shapes", ADMITTED_EDGES)
def test_admitted_edge_shapes(shapes):
    assert hopper_supported(*shapes, BF16)
    assert kernel_path(*shapes, BF16) == "hopper"


@pytest.mark.parametrize("name", ["L", "H"])
def test_presets_with_other_block_sizes_take_the_general_kernel(name):
    """L (blocks of 96 channels) and H (256) are refused by the gate of
    blocks of 128 channels in bf16: L takes the kernel for blocks of 96
    channels (afno_hopper_l.cu), H the one for blocks of 256 channels
    (afno_hopper_wide.cu)."""
    shapes = preset_shapes(name)
    assert not hopper_supported(*shapes, BF16)
    assert kernel_path(*shapes, BF16) == ("hopper_wide" if name == "H" else "hopper_l")


@pytest.mark.parametrize("shapes", [
    (3, 64, 96, 9, 4, 8),      # 8x8 latent, modes 3: bs 24, 2K = 18
    (3, 48, 40, 15, 2, 4),     # 4x12 latent, modes 5: bs 20
    (1, 64, 512, 20, 4, 8),    # 8x8 latent: 64 px
    (1, 1024, 512, 144, 4, 8), # 32x32 latent: the slab does not fit
    (1, 256, 512, 143, 4, 8),  # K not a multiple of 4
    (1, 256, 512, 164, 4, 8),  # 2K = 328: o does not fit the synthesis CTA
    (1, 256, 512, 144, 4, 2),  # groups of 256 channels straddle AFNO blocks
    (1, 256, 512, 144, 4, 128),  # groups of 4 channels
    (0, 256, 512, 144, 4, 8),  # empty batch
])
def test_ragged_and_unfit_shapes_are_refused(shapes):
    """Refused shapes go to the streamed kernel (afno_hopper_stream.cu)
    where its gate admits them (a latent up to 4096 px that this gate
    refuses, any K), else to the five-launch kernel."""
    assert not hopper_supported(*shapes, BF16)
    stream = hopper_stream_supported(*shapes, BF16)
    assert kernel_path(*shapes, BF16) == ("hopper_stream" if stream else "general")


@pytest.mark.parametrize("name", ["Ti", "S", "M", "L", "H"])
def test_f32_always_takes_the_general_kernel(name):
    """f32 never takes the bf16 Hopper kernel: Ti, S and M (AFNO blocks of
    128 channels) take the f32 Hopper kernel (afno_hopper_f32.cu), L (96)
    the f32 kernel for 96-channel blocks (afno_hopper_f32_l.cu), H (256)
    the f32 kernel for 256-channel blocks (afno_hopper_f32_wide.cu)."""
    shapes = preset_shapes(name)
    assert not hopper_supported(*shapes, F32)
    want = {"L": "hopper_f32_l", "H": "hopper_f32_wide"}.get(name, "hopper_f32")
    assert kernel_path(*shapes, F32) == want


def test_gate_is_a_pure_function_of_shapes():
    """Same answer for the same shapes, whatever was asked before."""
    a = [hopper_supported(*preset_shapes(n, B), BF16) for n in MODEL_PRESETS for B in (1, 7)]
    b = [hopper_supported(*preset_shapes(n, B), BF16) for n in MODEL_PRESETS for B in (1, 7)]
    assert a == b == [n in ("Ti", "S", "M") for n in MODEL_PRESETS for _ in (1, 7)]


def test_bf16_weight_blocks_are_cached_until_the_weight_changes():
    """(2, nb, bs, bs) f32 -> bf16 with each block transposed to (out, in);
    the copy is kept while the weight is unchanged and made anew after an
    in-place update (an optimizer step)."""
    w = torch.nn.Parameter(torch.randn(2, 3, 4, 4))
    first = afno_fused._bf16_blocks(w)
    assert first.dtype == BF16 and first.is_contiguous()
    torch.testing.assert_close(first.float(), w.detach().transpose(-1, -2).to(BF16).float(),
                               rtol=0, atol=0)
    assert afno_fused._bf16_blocks(w) is first
    with torch.no_grad():
        w.add_(1.0)
    second = afno_fused._bf16_blocks(w)
    assert second is not first
    torch.testing.assert_close(second.float(), w.detach().transpose(-1, -2).to(BF16).float(),
                               rtol=0, atol=0)
    with torch.inference_mode():
        v = torch.randn(2, 1, 4, 4)
    assert afno_fused._bf16_blocks(v).shape == (2, 1, 4, 4)


def test_launch_counts_by_path_start_at_zero_keys():
    assert set(afno_fused.fused_gn_afno.launches_by_path) == {
        "hopper", "hopper_wide", "hopper_l", "hopper_f32", "hopper_f32_l", "hopper_f32_wide",
        "hopper_pairs", "hopper_f32_pairs", "hopper_stream", "general"}


def test_bf16_weight_copies_are_made_inside_a_profiler_range():
    """A trace can find the copies' work under BF16_BLOCKS_RANGE (the smoke
    run adds it to the forward's share of a train step); a cache hit makes
    no copy and opens no range."""
    from torch.profiler import ProfilerActivity, profile

    w = torch.nn.Parameter(torch.randn(2, 2, 8, 8))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        afno_fused._bf16_blocks(w)
        afno_fused._bf16_blocks(w)
    names = [e.name for e in prof.events()]
    assert names.count(afno_fused.BF16_BLOCKS_RANGE) == 1
