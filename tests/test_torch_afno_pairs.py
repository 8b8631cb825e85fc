"""The pair paths of the fused op (dpot_tpu_torch/ops/cuda/afno_fused.py
"hopper_pairs", "hopper_f32_pairs") on the CPU: AFNO blocks of 64 channels,
configs/afno_config_single.yaml's (C 512, 8 blocks, GroupNorm(8)), packed two
at a time into 128-channel blocks with block-diagonal weights and run on
afno_hopper.cu (bf16) or afno_hopper_f32.cu (f32) with nb/2 blocks. Checked
here: the gates and the path choice, the packing's exactness through the
plain version, the packed copies' cache, and the plain version and a
two-layer model at the config's widths against the JAX package. The kernels
themselves run only on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""

from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch
import yaml

from dpot_tpu_torch.ops.cuda import afno_fused, build
from dpot_tpu_torch.ops.cuda.afno_fused import (
    PAIR_KERNELS,
    PATHS,
    fused_gn_afno,
    fused_gn_afno_ref,
    hopper_f32_pairs_supported,
    hopper_pairs_supported,
    hopper_stream_supported,
    kernel_path,
    pack_pairs,
)
from dpot_tpu_torch.ops.spectral import kept_modes
from test_torch_afno_f32 import _seeded_args
from test_torch_afno_hopper import preset_shapes
from test_torch_model import both, rand_x

BF16, F32 = torch.bfloat16, torch.float32
SINGLE_CONFIG = Path(__file__).resolve().parent.parent / "configs" / "afno_config_single.yaml"
GATES = {BF16: (hopper_pairs_supported, "hopper_pairs"),
         F32: (hopper_f32_pairs_supported, "hopper_f32_pairs")}


def single_shapes(B: int) -> tuple:
    """(B, HW, C, K, nb, groups) of a trunk block of
    configs/afno_config_single.yaml: 128^2, patch 8, width 512, 8 blocks,
    modes 32, GroupNorm(8)."""
    cfg = yaml.safe_load(SINGLE_CONFIG.read_text())
    h = cfg["res"] // cfg["patch_size"]
    kh, kw = kept_modes(h, h, cfg["modes"])
    return B, h * h, cfg["width"], kh * kw, cfg["n_blocks"], 8


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("B", [1, 8, 32])
def test_the_config_takes_the_pair_path(B, dtype):
    """The config's blocks are 64 channels, one GroupNorm group each, at a
    256-px latent with K = 144: no gate for 128, 256 or 96 channels admits
    them; the pair gate of the type does."""
    shapes = single_shapes(B)
    _, HW, C, K, nb, groups = shapes
    assert (HW, C, K, nb, C // nb, C // groups) == (256, 512, 144, 8, 64, 64)
    gate, path = GATES[dtype]
    assert gate(*shapes, dtype)
    assert kernel_path(*shapes, dtype) == path


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("groups", [4, 8])
def test_a_tp_rank_share_takes_the_pair_path(dtype, groups):
    """A rank's share of the config over model = 2: C 256, 4 blocks, and
    GroupNorm's groups halved with the channels (4) or kept at 64 channels."""
    shapes = (4, 256, 256, 144, 4, groups)
    gate, path = GATES[dtype]
    assert gate(*shapes, dtype) and kernel_path(*shapes, dtype) == path


ADMITTED_PAIR_EDGES = [
    (2, 256, 128, 144, 2, 2),    # one pair, a group a block
    (2, 256, 512, 144, 8, 16),   # groups of 32
    (2, 256, 512, 144, 8, 64),   # groups of 8
    (2, 128, 512, 40, 8, 8),     # 16x8 latent, modes 8
    (2, 256, 512, 160, 8, 8),    # 32x8 latent, modes 32: 2K = 320
    (2, 256, 512, 4, 8, 8),      # modes 2: 2K = 8
]


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("shapes", ADMITTED_PAIR_EDGES)
def test_admitted_pair_edge_shapes(shapes, dtype):
    gate, path = GATES[dtype]
    assert gate(*shapes, dtype) and kernel_path(*shapes, dtype) == path


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("shapes,why", [
    ((2, 256, 448, 144, 7, 7), "an odd count of 64-channel blocks"),
    ((2, 256, 64, 144, 1, 1), "one 64-channel block"),
    ((2, 256, 512, 144, 8, 4), "groups of 128 channels straddle two blocks"),
    ((2, 256, 512, 144, 8, 2), "groups of 256 channels"),
    ((2, 256, 512, 144, 8, 128), "groups of 4 channels"),
    ((2, 256, 512, 144, 8, 24), "C % groups"),
    ((2, 256, 384, 144, 8, 8), "blocks of 48 channels"),
    ((0, 256, 512, 144, 8, 8), "empty batch"),
    ((65536, 256, 512, 144, 8, 8), "a batch beyond the grid's z dimension"),
    ((2, 8192, 512, 144, 8, 8), "above the combined-operator DFT's limit"),
])
def test_the_pair_gates_refuse(shapes, why, dtype):
    """Refused shapes go to the five-launch kernel."""
    gate, _ = GATES[dtype]
    assert not gate(*shapes, dtype), why
    assert kernel_path(*shapes, dtype) == "general", why


@pytest.mark.parametrize("shapes", [
    (2, 512, 512, 144, 8, 8),    # a 512-px latent: the bf16 slab does not fit
    (2, 64, 512, 16, 8, 8),      # a 64-px latent: no 128-px synthesis tile
    (2, 1024, 512, 144, 8, 8),   # a 32x32 latent
    (2, 256, 512, 142, 8, 8),    # K even but not a multiple of 4
    (2, 256, 512, 164, 8, 8),    # 2K = 328: o does not fit the synthesis CTA
    (2, 256, 512, 143, 8, 8),    # K odd
    (2, 96, 512, 40, 8, 8),      # 96 px: not a bf16 latent
])
def test_the_bf16_pair_gate_refuses_what_only_f32_takes(shapes):
    """The bf16 latent rule (128 or 256 px, K a multiple of 4, 2K <= 320)
    against the f32 one (any latent up to 4096 px, any K). In bf16 the streamed
    kernel takes each of them (64-channel blocks, unpacked)."""
    assert not hopper_pairs_supported(*shapes, BF16)
    assert hopper_stream_supported(*shapes, BF16)
    assert kernel_path(*shapes, BF16) == "hopper_stream"
    assert hopper_f32_pairs_supported(*shapes, F32)


@pytest.mark.parametrize("B", [1, 8, 32])
def test_each_pair_gate_refuses_the_other_type(B):
    shapes = single_shapes(B)
    assert not hopper_pairs_supported(*shapes, F32)
    assert not hopper_f32_pairs_supported(*shapes, BF16)
    for dtype in (torch.float16, torch.float64):
        assert not hopper_pairs_supported(*shapes, dtype)
        assert not hopper_f32_pairs_supported(*shapes, dtype)


def test_all_gates_are_disjoint_pure_functions_of_shapes():
    """At most one gate admits any shape, the path is that gate's, and a
    gate's answer does not depend on what was asked before; the pair paths
    come before "general" and have launch counts. The shapes include the
    streamed kernel's (every preset at 64^2 and 256^2, patch 8, and its
    edges), which no other gate may admit in bf16."""
    from test_torch_afno_stream import ADMITTED_STREAM_EDGES

    gates = dict(zip(PATHS, afno_fused._GATES))
    shapes = [single_shapes(B) for B in (1, 8, 32)] + ADMITTED_PAIR_EDGES
    shapes += [preset_shapes(n, B) for n in ("Ti", "S", "L", "H") for B in (1, 7)]
    shapes += [preset_shapes(n, B, res=r) for n in ("Ti", "S", "M", "L", "H") for B in (1, 20)
               for r in (64, 256)]
    shapes += ADMITTED_STREAM_EDGES
    shapes += [(2, 256, 1536, 144, 16, 8), (2, 256, 256, 144, 4, 4), (2, 256, 256, 144, 1, 1)]
    asks = [(*s, dt) for s in shapes for dt in (F32, BF16)]
    for gate in gates.values():
        assert [gate(*a) for a in asks] == [gate(*a) for a in reversed(asks)][::-1]
    for a in asks:
        admitting = [p for p, gate in gates.items() if gate(*a)]
        assert len(admitting) <= 1, (a, admitting)
        assert kernel_path(*a) == (admitting[0] if admitting else "general")
    assert PATHS[-1] == "general" and len(afno_fused._GATES) == len(PATHS) - 1
    assert set(PAIR_KERNELS) <= set(PATHS) and tuple(fused_gn_afno.launches_by_path) == PATHS


def test_the_pair_paths_load_the_128_channel_libraries():
    """"hopper_pairs" launches afno_hopper.cu's dpot_afno_hopper and
    "hopper_f32_pairs" afno_hopper_f32.cu's dpot_afno_hopper_f32: no source
    of their own."""
    assert PAIR_KERNELS == {"hopper_pairs": "hopper", "hopper_f32_pairs": "hopper_f32"}
    libs = build.library_paths()
    for kernel in PAIR_KERNELS.values():
        assert "afno_" + kernel in libs
        src = (build.SRC_DIR / f"afno_{kernel}.cu").read_text()
        assert f'extern "C" int dpot_afno_{kernel}(' in src
    assert not any(p.name.startswith("afno_hopper_pairs") for p in build.SRC_DIR.iterdir())


def test_pack_pairs_is_block_diagonal():
    w = torch.randn(2, 6, 4, 4)
    p = pack_pairs(w)
    assert p.shape == (2, 3, 8, 8) and p.dtype == w.dtype
    for i in range(3):
        assert torch.equal(p[:, i, :4, :4], w[:, 2 * i])
        assert torch.equal(p[:, i, 4:, 4:], w[:, 2 * i + 1])
        assert not p[:, i, :4, 4:].any() and not p[:, i, 4:, :4].any()
    assert torch.equal(pack_pairs(w.to(BF16)), p.to(BF16))


def _packed(args):
    """The same call at nb/2 blocks of 128: packed weights, the biases seen
    as (2, nb/2, 128), which is the same memory."""
    x, gs, gb, A, Ainv, w1, b1, w2, b2, K, groups = args
    nb, bs = w1.shape[1], w1.shape[2]
    b1p, b2p = (b.view(2, nb // 2, 2 * bs) for b in (b1, b2))
    assert b1p.data_ptr() == b1.data_ptr() and b2p.data_ptr() == b2.data_ptr()
    return (x, gs, gb, A, Ainv, pack_pairs(w1), b1p, pack_pairs(w2), b2p, K, groups)


@pytest.mark.parametrize("act", ["gelu", "silu"])
@pytest.mark.parametrize("shape", [
    dict(B=2, H=16, W=16, C=512, nb=8, modes=8, groups=8),   # the config's block layout
    dict(B=1, H=16, W=8, C=256, nb=4, modes=4, groups=16),   # groups of 16
])
def test_packing_is_exact_through_the_plain_version(shape, act):
    """The plain version with the packed weights at nb/2 blocks of 128
    equals the call at nb blocks of 64: within 1e-6 in f32 (the order of
    the f32 sums), bit for bit in bf16, whose rounding points (xn, z, h, o)
    are the same."""
    args = _seeded_args(shape["B"], shape["H"], shape["W"], shape["C"], shape["nb"],
                        shape["modes"], shape["groups"], seed=31)
    for approx in (False, True):
        want = fused_gn_afno_ref(*args, approximate=approx, act=act)
        got = fused_gn_afno_ref(*_packed(args), approximate=approx, act=act)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
    x, gs, gb, _, _, *rest = args
    kh, kw = kept_modes(shape["H"], shape["W"], shape["modes"])
    from dpot_tpu_torch.ops.spectral import combined_spectral_ops

    A, Ainv = combined_spectral_ops(shape["H"], shape["W"], kh, kw, BF16, torch.device("cpu"))
    args16 = (x.to(BF16), gs, gb, A, Ainv, *rest)
    want = fused_gn_afno_ref(*args16, approximate=True, act=act)
    got = fused_gn_afno_ref(*_packed(args16), approximate=True, act=act)
    assert want.dtype == BF16 and torch.equal(got, want)


def test_a_swapped_pair_is_not_the_same_mixer():
    """The control of the smoke's step check: the pair packed in the wrong
    order moves the output far beyond the f32 limits."""
    args = _seeded_args(2, 16, 16, 512, 8, 8, 8, seed=32)
    swapped = list(args)
    for i in (5, 7):
        w = args[i]
        swapped[i] = torch.stack([w[:, 1::2], w[:, 0::2]], dim=2).flatten(1, 2)
    want = fused_gn_afno_ref(*_packed(args), approximate=False)
    wrong = fused_gn_afno_ref(*_packed(tuple(swapped)), approximate=False)
    assert ((wrong - want).norm() / want.norm()).item() > 1e-3


@pytest.mark.parametrize("kind", ["bf16", "f32"])
def test_packed_copies_are_cached_until_the_weight_changes(kind):
    """One packed copy per weight version: kept while the weight is
    unchanged, made anew after an in-place update (an optimizer step)."""
    def copy(w):
        return afno_fused._bf16_blocks(w, pairs=True) if kind == "bf16" else \
            afno_fused._f32_pairs(w)

    def fresh(w):
        p = pack_pairs(w.detach().float())
        return p.transpose(-1, -2).to(BF16) if kind == "bf16" else p

    w = torch.nn.Parameter(torch.randn(2, 4, 8, 8))
    first = copy(w)
    assert first.is_contiguous() and first.shape == (2, 2, 16, 16)
    assert first.dtype == (BF16 if kind == "bf16" else F32)
    assert torch.equal(first, fresh(w))
    assert copy(w) is first
    with torch.no_grad():
        w.add_(1.0)
    second = copy(w)
    assert second is not first and torch.equal(second, fresh(w))
    # the unpacked bf16 copy is a cache of its own
    if kind == "bf16":
        assert afno_fused._bf16_blocks(w).shape == (2, 4, 8, 8)
        assert afno_fused._bf16_blocks(w, pairs=True) is second


@pytest.mark.parametrize("kind", ["bf16", "f32"])
def test_packed_copies_are_not_kept_for_uncached_or_captured_weights(kind, monkeypatch):
    """FSDP2's gathered weights (`_dpot_block_cache = False`) and a CUDA
    graph's capture convert on every call and keep nothing; an inference
    tensor too."""
    attr = "_dpot_bf16_pairs" if kind == "bf16" else "_dpot_f32_pairs"

    def copy(w):
        return afno_fused._bf16_blocks(w, pairs=True) if kind == "bf16" else \
            afno_fused._f32_pairs(w)

    w = torch.nn.Parameter(torch.randn(2, 2, 4, 4))
    w._dpot_block_cache = False
    a, b = copy(w), copy(w)
    assert a is not b and torch.equal(a, b) and not hasattr(w, attr)
    v = torch.nn.Parameter(torch.randn(2, 2, 4, 4))
    monkeypatch.setattr(afno_fused, "capturing", lambda: True)
    assert copy(v) is not copy(v) and not hasattr(v, attr)
    monkeypatch.undo()
    with torch.inference_mode():
        u = torch.randn(2, 2, 4, 4)
    assert copy(u).shape == (2, 1, 8, 8)


def test_a_bf16_working_copy_is_upcast_before_packing():
    """afno_hopper_f32.cu reads f32 weights: the f32 packed copy of a bf16
    working copy is its exact upcast, packed."""
    w = torch.nn.Parameter(torch.randn(2, 4, 8, 8).to(BF16))
    got = afno_fused._f32_pairs(w)
    assert got.dtype == F32 and torch.equal(got, pack_pairs(w.detach().float()))


@pytest.mark.parametrize("shape", [
    dict(B=2, H=16, W=16, C=512, nb=8, modes=8, groups=8),   # the config's block layout
    dict(B=1, H=16, W=8, C=256, nb=4, modes=8, groups=4),    # a TP rank's share
])
def test_plain_version_at_64_channel_blocks_matches_jax(shape):
    """The yardstick of both pair paths, at shapes their gates admit,
    against the JAX f32 model path (group_norm, then afno_filter_2d with
    the residual of the normed input, erf-GELU), within 2e-5 absolute: f32
    throughout, another summation order. On the CPU the wrapper runs this
    plain version and launches nothing."""
    from dpot_tpu.ops.activations import get_activation
    from dpot_tpu.ops.norms import group_norm as jax_group_norm
    from dpot_tpu.ops.spectral import afno_filter_2d

    B, H, W, C = shape["B"], shape["H"], shape["W"], shape["C"]
    args = _seeded_args(B, H, W, C, shape["nb"], shape["modes"], shape["groups"], seed=33,
                        scale=0.2)
    x, gs, gb, _, _, w1, b1, w2, b2, K, groups = args
    assert kernel_path(B, H * W, C, K, shape["nb"], groups, F32) == "hopper_f32_pairs"
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


# configs/afno_config_single.yaml's widths (embed 512, 8 AFNO blocks of 64,
# mlp_ratio 1) at depth 2 on a 64^2 grid, patch 8 (an 8x8 latent), modes 4
SINGLE_WIDTHS = dict(img_size=64, patch_size=8, in_channels=4, out_channels=4,
                     in_timesteps=10, out_timesteps=1, embed_dim=512, depth=2, n_blocks=8,
                     mlp_ratio=1.0, modes=4, n_cls=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_layers_at_the_config_widths_match_jax(dtype):
    """f32 at the interop bar (2e-4 absolute), with the port's weights
    carried into the JAX model by dpot_params_from_torch; bf16 at the bf16
    model bar (relative L2 below 2e-2: the two packages round at different
    points)."""
    x = rand_x((2, 64, 64, 10, 4), seed=34)
    (ty, tc), (jy, jc) = both(x, dtype=dtype, cfg=SINGLE_WIDTHS)
    assert ty.shape == jy.shape == (2, 64, 64, 1, 4) and np.isfinite(ty).all()
    if dtype == "float32":
        np.testing.assert_allclose(ty, jy, atol=2e-4, rtol=0)
        np.testing.assert_allclose(tc, jc, atol=2e-4, rtol=0)
    else:
        assert np.linalg.norm(ty - jy) / np.linalg.norm(jy) < 2e-2
