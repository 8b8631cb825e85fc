"""The streamed bf16 path of the fused op (dpot_tpu_torch/ops/cuda/afno_fused.py
"hopper_stream", dpot_tpu_torch/csrc/afno_hopper_stream.cu) on the CPU: bf16
at the latents up to 4096 pixels that the other bf16 kernels refuse (a 64^2
grid at patch 8 gives an 8^2 latent, K 40; a 256^2 grid a 32^2 latent, K
544; ragged latents and odd K, tests/test_torch_afno_ragged.py), AFNO blocks
of 64, 96, 128 or 256 channels. Checked here: the
gate and the path choice, the kernel's launch geometry and shared-memory
plan mirrored from its source's constants, and the plain version and a
two-layer model at those grids against the JAX package. The kernel itself
runs only on the card (tests/test_torch_gpu.py -k stream, chip_smoke.py).
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from dpot_tpu_torch.ops.cuda import build
from dpot_tpu_torch.ops.cuda.afno_fused import (
    BF16_WEIGHT_PATHS,
    PATHS,
    fused_gn_afno,
    hopper_stream_supported,
    kernel_path,
    padded_dims,
)
from test_torch_afno_hopper import preset_shapes
from test_torch_afno_kernel import jax_args, make_case, port_args
from test_torch_model import jax_params, rand_x

BF16, F32 = torch.bfloat16, torch.float32
MEDIUM_CONFIG = Path(__file__).resolve().parent.parent / "configs" / "pretrain_medium.yaml"
SMEM_LIMIT = 232448  # 227 KB, what a CTA may have on the H100


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test files at once, some of them timing host
    throughput; torch's CPU ops here keep to two threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_the_medium_config_is_dpot_m_in_bf16():
    """configs/pretrain_medium.yaml trains DPOT-M's widths in bf16 at res
    128; its blocks at res 64 and 256 are the shapes this path takes."""
    cfg = yaml.safe_load(MEDIUM_CONFIG.read_text())
    t = cfg["tasks"]
    assert cfg["dtype"] == "bfloat16" and cfg["model"] == "DPOT"
    assert (t["width"], t["n_blocks"], t["patch_size"], t["modes"]) == ([1024], [8], [8], [32])
    assert preset_shapes("M", 20, res=64)[1:] == (64, 1024, 40, 8, 8)
    assert preset_shapes("M", 20, res=256)[1:] == (1024, 1024, 544, 8, 8)


@pytest.mark.parametrize("B", [1, 8, 20])
@pytest.mark.parametrize("name,res", [("M", 64), ("M", 256), ("L", 256), ("Ti", 256),
                                      ("H", 64), ("S", 64)])
def test_the_slice_shapes_take_the_stream_path(name, res, B):
    """DPOT-M at the 8^2 and 32^2 latents, L (96-channel blocks, groups of a
    block pair) and Ti at the 32^2 latent, H (256-channel blocks) and S at
    the 8^2 latent: bf16 on hopper_stream, f32 on the f32 kernel of the
    block size, as before."""
    shapes = preset_shapes(name, B, res=res)
    assert hopper_stream_supported(*shapes, BF16)
    assert kernel_path(*shapes, BF16) == "hopper_stream"
    assert not hopper_stream_supported(*shapes, F32)
    f32 = {"L": "hopper_f32_l", "H": "hopper_f32_wide"}.get(name, "hopper_f32")
    assert kernel_path(*shapes, F32) == f32


# each kind of shape the stream gate admits, as tests/test_torch_gpu.py
# runs the kernel on the card: (B, HW, C, K, nb, groups)
ADMITTED_STREAM_EDGES = [
    (2, 64, 320, 40, 5, 5),        # 64-channel blocks in an odd count, a group a block
    (2, 64, 192, 40, 3, 24),       # 64-channel blocks, groups of 8
    (2, 1024, 768, 544, 8, 4),     # 96-channel blocks, groups of a block pair
    (2, 64, 384, 40, 4, 4),        # 96-channel blocks, a group a block
    (2, 4096, 256, 144, 2, 8),     # a 64^2 latent, the largest
    (2, 512, 512, 144, 4, 8),      # 512 px
    (2, 256, 512, 164, 4, 8),      # 256 px with 2K = 328: too many rows of o for afno_hopper.cu
    (2, 256, 512, 142, 4, 8),      # 256 px, K even but not a multiple of 4
    (2, 1024, 128, 2, 1, 1),       # K 2: one short mode chunk
    (2, 64, 512, 4, 2, 2),         # 256-channel blocks, a group a block
    (2, 144, 512, 60, 4, 8),       # a 96^2 grid at patch 8: 144 px, padded to 192
    (2, 1024, 1024, 543, 8, 8),    # K odd: Kp 544, Ainv's rows whole 16-byte units
    (2, 32, 512, 10, 4, 8),        # 32 px: below one 64-px tile, padded to one
]


@pytest.mark.parametrize("shapes", ADMITTED_STREAM_EDGES)
def test_admitted_stream_edge_shapes(shapes):
    assert hopper_stream_supported(*shapes, BF16)
    assert kernel_path(*shapes, BF16) == "hopper_stream"


@pytest.mark.parametrize("shapes,why", [
    ((2, 1024, 1280, 544, 8, 8), "blocks of 160 channels"),
    ((2, 1024, 1024, 544, 8, 2), "groups of 512 channels straddle 128-channel blocks"),
    ((2, 1024, 1024, 544, 8, 256), "groups of 4 channels"),
    ((2, 1024, 480, 544, 5, 5), "an odd count of 96-channel blocks: C not a multiple of 64"),
    ((2, 1024, 384, 544, 4, 1), "groups of 384 channels over 96-channel blocks"),
    ((2, 8192, 1024, 544, 8, 8), "above the combined-operator DFT's limit"),
    ((0, 64, 1024, 40, 8, 8), "empty batch"),
    ((65536, 64, 1024, 40, 8, 8), "a batch beyond the grid's z dimension"),
])
def test_the_stream_gate_refuses(shapes, why):
    assert not hopper_stream_supported(*shapes, BF16), why
    assert kernel_path(*shapes, BF16) == "general", why


@pytest.mark.parametrize("B", [1, 20])
@pytest.mark.parametrize("name", ["Ti", "S", "M", "L", "H"])
def test_the_128_and_256_px_shapes_keep_their_kernels(name, B):
    """At a 16^2 latent (128^2 at patch 8, K 144) and a 16x8 one (K 40) the
    other bf16 kernels keep what they take: the stream gate refuses every
    shape `_bf16_hopper_latent` admits."""
    want = {"L": "hopper_l", "H": "hopper_wide"}.get(name, "hopper")
    _, _, C, _, nb, groups = preset_shapes(name, B)
    for shapes in (preset_shapes(name, B), (B, 128, C, 40, nb, groups)):
        assert not hopper_stream_supported(*shapes, BF16)
        assert kernel_path(*shapes, BF16) == want, shapes


@pytest.mark.parametrize("shapes", ADMITTED_STREAM_EDGES + [preset_shapes("M", 8, res=256)])
def test_the_stream_gate_refuses_f32(shapes):
    assert not hopper_stream_supported(*shapes, F32)
    assert kernel_path(*shapes, F32) != "hopper_stream"
    for dtype in (torch.float16, torch.float64):
        assert not hopper_stream_supported(*shapes, dtype)


def test_the_path_reads_the_bf16_weight_copies_and_has_a_launch_count():
    """The kernel reads the cached bf16 copies (each block transposed), so
    it follows `_cached`'s rules; its path comes just before "general"."""
    assert "hopper_stream" in BF16_WEIGHT_PATHS
    assert PATHS[-2:] == ("hopper_stream", "general")
    assert tuple(fused_gn_afno.launches_by_path) == PATHS
    src = (build.SRC_DIR / "afno_hopper_stream.cu").read_text()
    assert 'extern "C" int dpot_afno_hopper_stream(' in src
    assert 'extern "C" int dpot_afno_hopper_stream_supported(' in src
    assert "afno_hopper_stream" in build.library_paths()


def _source() -> str:
    return (build.SRC_DIR / "afno_hopper_stream.cu").read_text()


def _constants() -> dict[str, int]:
    """The namespace-level `constexpr int NAME = <expression>;` of
    afno_hopper_stream.cu, in order, each evaluated with integer division
    over the ones before."""
    out: dict[str, int] = {}
    for m in re.finditer(r"^constexpr int (\w+) = ([^;]+);", _source(), re.MULTILINE):
        out[m[1]] = eval(m[2].replace("/", "//"), {}, dict(out))
    return out


def _py(expr: str) -> str:
    """A C++ integer expression (+ - * /, comparisons, && ||, ?:) as Python."""
    expr = expr.strip()
    depth, q = 0, None
    for i, ch in enumerate(expr):
        depth += (ch == "(") - (ch == ")")
        if ch == "?" and depth == 0:
            q = i
            break
    if q is None:
        return expr.replace("&&", " and ").replace("||", " or ").replace("/", "//")
    depth, nest = 0, 0
    for i in range(q + 1, len(expr)):
        ch = expr[i]
        depth += (ch == "(") - (ch == ")")
        if depth == 0 and ch == "?":
            nest += 1
        elif depth == 0 and ch == ":":
            if not nest:
                break
            nest -= 1
    return f"(({_py(expr[q + 1:i])}) if ({_py(expr[:q])}) else ({_py(expr[i + 1:])}))"


def _plan(struct: str, **params) -> dict[str, int]:
    """The `static constexpr int` members of template struct `struct` of the
    source (Spec<BS, MC>, Syn<TN>) at the template arguments `params`,
    evaluated in order over the namespace constants."""
    body = re.search(rf"^template <[^>]*> struct {struct} {{\n(.*?)^}};", _source(),
                     re.MULTILINE | re.DOTALL)[1]
    env = {**_constants(), **params}
    for m in re.finditer(r"static constexpr int (\w+) = ([^;]+);", body):
        env[m[1]] = eval(_py(m[2]), {}, dict(env))
    return env


def spectral_plan(bs: int) -> dict[str, int]:
    return _plan("Spec", BS=bs)


def synthesis_plan(tn: int) -> dict[str, int]:
    return _plan("Syn", TN=tn)


def launch_geometry(B, HW, C, K, nb, groups, sms=132) -> dict:
    """The grids of the three launches the source makes, at the padded
    operators' HWp and Kp (`padded_dims`): spectral CTAs of MC (64) modes;
    synthesis CTAs of 128 px by the widest tile of 256, 128 and 64 channels
    that divides C and whose grid fills the card (else 64); the statistics
    a CTA per group and sample."""
    c = _constants()
    HWp, Kp = padded_dims(HW, K)
    mc = c["MC"]
    tiles = math.ceil(HW / c["SYN_P"]) * B
    tn = next((t for t in (256, 128) if C % t == 0 and tiles * (C // t) >= sms), 64)
    return dict(mc=mc, tn=tn, HWp=HWp, Kp=Kp, stats=(groups, B),
                spectral=(math.ceil(Kp / mc), nb, B),
                synthesis=(math.ceil(HW / c["SYN_P"]), C // tn, B))


WGMMA_N = {64, 96, 128, 256}  # the widths the source's Frag<N> specialises


@pytest.mark.parametrize("bs", [64, 96, 128, 256])
def test_shared_memory_plan_fits_a_cta(bs):
    """The spectral CTA's ring (at least three stages, each the larger of
    an analysis stage and a weight stage), z/h/o and its mbarriers and
    column constants fit the 227 KB; every swizzled tile starts
    1024-aligned; the x tile holds whole 64-channel boxes over the block;
    the z buffer holds both parts of every 64-wide k-block; the products'
    widths are ones wgmma takes (and the source specialises); blocks of 64
    run two CTAs an SM."""
    g, c = spectral_plan(bs), _constants()
    mc = c["MC"]
    assert c["SMEM_MAX"] == SMEM_LIMIT and g["SMEM"] <= SMEM_LIMIT
    assert g["NS"] >= 3 and g["SLOT"] % 1024 == 0 == g["X_BYTES"] % 1024
    assert g["SLOT"] >= max(g["X_BYTES"] + g["A_BYTES"], g["W_BYTES"])
    assert g["X_BYTES"] == 128 * g["XCH"] and g["XCH"] % 64 == 0 and g["XCH"] >= bs
    assert g["A_BYTES"] == 2 * mc * 128 and g["W_BYTES"] == 128 * bs
    assert g["NKB"] * 64 >= bs > (g["NKB"] - 1) * 64
    assert g["Z_OFF"] == g["NS"] * g["SLOT"] and g["MISC"] == g["Z_OFF"] + 2 * g["NKB"] * c["BOX"]
    assert g["SMEM"] >= g["MISC"] + 16 * g["NS"] + 12 * g["XCH"] + 1023
    assert g["XCH"] in WGMMA_N and bs in WGMMA_N and g["XCH"] == 64 * g["NKB"]
    if bs == 64:
        assert g["MIN_CTAS"] == 2 and 2 * (g["SMEM"] + 1024) <= 233472
    src = _source()
    for n in WGMMA_N:
        assert f"template <> struct Frag<{n}>" in src and f"m64n{n}k16" in src


@pytest.mark.parametrize("tn", [64, 128, 256])
def test_synthesis_plan_fits_a_cta(tn):
    """The synthesis CTA's ring of Ainv rows and o boxes (at least three
    stages), its x tile and its mbarriers and column constants fit the 227
    KB, at a width wgmma takes."""
    g = synthesis_plan(tn)
    assert g["NS"] >= 3 and g["SMEM"] <= SMEM_LIMIT and tn in WGMMA_N
    assert g["AINV_BYTES"] == 128 * 128 and g["SLOT"] == g["AINV_BYTES"] + 128 * tn
    assert g["X_OFF"] == g["NS"] * g["SLOT"] and g["MISC"] == g["X_OFF"] + 256 * tn
    assert g["SMEM"] >= g["MISC"] + 8 * (2 * g["NS"] + 1) + 16 * tn + 1023


def test_the_source_is_wgmma_fed_by_tma():
    """Both the spectral and the synthesis launch issue their products as
    wgmma from shared-memory descriptors and load every operand tile by TMA
    (cp.async.bulk.tensor through hopper_tma.cuh), with full and empty
    mbarriers; no warp-level mma, no ldmatrix, no 16-byte cp.async."""
    src = _source()
    for gone in ("mma.sync", "ldmatrix", "cp.async.cg", "cp.async.ca", "cp.async.commit"):
        assert gone not in src, gone
    assert '#include "hopper_tma.cuh"' in src
    hdr = (build.SRC_DIR / "hopper_tma.cuh").read_text()
    assert "cp.async.bulk.tensor" in hdr and "wgmma.mma_async" in src
    for kernel in ("stream_spectral_kernel", "stream_synthesis_kernel"):
        body = src[src.index(f"\n{kernel}("):]
        body = body[:body.index("\n}\n")]
        assert "tma_load_" in body and "mbar_wait" in body and "mma<" in body, kernel


# every admitted shape the tests here and on the card use
GEOMETRY_SHAPES = (ADMITTED_STREAM_EDGES
                   + [preset_shapes(n, B, res=r) for n in ("M", "L", "H")
                      for B in (1, 8, 20) for r in (64, 256)]
                   + [preset_shapes(n, B, res=r) for n in ("M", "L", "H")
                      for B in (1, 8, 20) for r in (72, 96, 160)]
                   + [preset_shapes("M", B, res=64, patch=16) for B in (1, 20)])


@pytest.mark.parametrize("shapes", GEOMETRY_SHAPES)
def test_launch_geometry_covers_every_mode_and_pixel(shapes):
    """The spectral grid's mode chunks cover Kp (the last one ragged where
    the chunk does not divide Kp: TMA fills A's rows past Kp with zeros),
    its 64-px stages cover HWp exactly; the synthesis tiles cover HW (the
    rows past it dropped by the store) and C exactly, each a width wgmma
    takes; the statistics launch deals whole 8-channel columns of a group
    to its threads."""
    B, HW, C, K, nb, groups = shapes
    g, c = launch_geometry(B, HW, C, K, nb, groups), _constants()
    mc, chunks = g["mc"], g["spectral"][0]
    HWp, Kp = g["HWp"], g["Kp"]
    assert Kp % c["KP_UNIT"] == 0 and K <= Kp < K + c["KP_UNIT"]
    assert (chunks - 1) * mc < Kp <= chunks * mc
    assert HWp % c["PX"] == 0 and HWp - c["PX"] < HW <= HWp
    rows, tiles_c = g["synthesis"][0] * c["SYN_P"], g["synthesis"][1]
    assert rows - c["SYN_P"] < HW <= rows and tiles_c * g["tn"] == C and g["tn"] in WGMMA_N
    assert math.ceil(2 * Kp / c["SYN_K"]) * c["SYN_K"] >= 2 * Kp
    cpg, nt = C // groups, c["STATS_NT"]
    cols = cpg // 8
    assert cpg % 8 == 0 and 1 <= cols <= nt and HW >= 1


@pytest.mark.parametrize("shapes", GEOMETRY_SHAPES)
def test_tensor_map_strides_are_16_byte_multiples(shapes):
    """A tensor map's global strides must be multiples of 16 bytes and its
    box at most 256 elements a side, its inner side 128 bytes under the
    128-byte swizzle: x and out (B, HW, C), A (2, Kp, HWp), the weights (2,
    nb, bs, bs), Ainv (HWp, 2Kp) and o (B, 2Kp, C), all bf16, at the
    padded Kp, a multiple of 4 (Ainv's rows are 4 Kp bytes)."""
    B, HW, C, K, nb, groups = shapes
    HWp, Kp = padded_dims(HW, K)
    bs = C // nb
    maps = {"x": (C, HW, B), "A": (HWp, Kp, 2), "w": (bs, bs, nb, 2), "Ainv": (2 * Kp, HWp),
            "o": (C, 2 * Kp, B)}
    for name, dims in maps.items():
        stride = 2
        for d in dims[:-1]:
            stride *= d
            assert stride % 16 == 0, (name, dims)
    c = _constants()
    boxes = [(64, c["PX"], 1), (c["PX"], c["MC"], 1),
             (64, bs, 1, 1), (64, c["SYN_P"], 1), (64, c["SYN_K"], 1), (c["SYN_K"], c["SYN_P"])]
    for box in boxes:
        assert box[0] * 2 == 128 and max(box) <= 256


def _control_kstore(Kp: int) -> int:
    """The first mode the dropped-chunk control leaves out of o, as the
    source computes it: the start of the last DROP_UNIT-mode chunk of Kp."""
    unit = _constants()["DROP_UNIT"]
    return (Kp - 1) // unit * unit


def test_the_ragged_chunk_of_the_slice():
    """What the smoke's dropped-chunk control leaves out, whatever chunk the
    spectral launch runs: at DPOT-M's 8^2 latent (K 40) the 8 modes 32..39,
    at 12^2 (K 84) the 20 modes 64..83, at 32^2 (K 544) the 32 modes
    512..543, at B = 1 as at B = 20; the source computes it so, and refuses
    the control where Kp <= 32 (there would be nothing left)."""
    for res, B, first in ((64, 1, 32), (64, 20, 32), (96, 1, 64), (96, 20, 64),
                          (256, 1, 512), (256, 20, 512)):
        _, HW, C, K, nb, groups = preset_shapes("M", B, res=res)
        assert _control_kstore(padded_dims(HW, K)[1]) == first
    src = _source()
    assert "const int kstore = drop ? (Kp - 1) / DROP_UNIT * DROP_UNIT : Kp;" in src
    assert "if (drop && Kp <= DROP_UNIT) return cudaErrorInvalidValue;" in src


@pytest.mark.parametrize("B", [1, 8, 20])
@pytest.mark.parametrize("res", [64, 72, 80, 96, 160, 192, 256])
def test_the_control_leaves_out_some_modes_and_keeps_some(res, B):
    """At every grid of configs/pretrain_medium.yaml's model the control
    leaves out at least one mode and at most DROP_UNIT, and keeps at least
    one, so that it is a fault and not an empty output. The spectral
    launch's own chunks (64 modes) need not number two: at the 8^2 latent
    it runs one; where Kp exceeds 64 they do."""
    _, HW, C, K, nb, groups = preset_shapes("M", B, res=res)
    c = _constants()
    Kp = padded_dims(HW, K)[1]
    kstore = _control_kstore(Kp)
    assert 0 < kstore < Kp and Kp - kstore <= c["DROP_UNIT"]
    g = launch_geometry(B, HW, C, K, nb, groups)
    assert g["spectral"][0] >= (2 if Kp > c["MC"] else 1)


@pytest.mark.parametrize("H,C,nb,groups", [(8, 128, 1, 8), (32, 256, 2, 4)])
def test_plain_version_matches_the_xla_reference_at_the_slice_latents(H, C, nb, groups):
    """The yardstick of the stream kernel at (HW 64, K 40) and (HW 1024, K
    544), against the JAX package's `_xla_reference` in f32 (tanh-GELU):
    1e-5 absolute, the same f32 arithmetic in another order. On the CPU the
    wrapper runs this plain version and launches nothing."""
    import jax

    from dpot_tpu.ops.pallas.afno_fused import _xla_reference

    c = make_case(B=1, H=H, W=H, C=C, nb=nb, modes=32, groups=groups, seed=41)
    args = port_args(c)
    assert args[9] == {8: 40, 32: 544}[H]
    assert kernel_path(1, H * H, C, args[9], nb, groups, BF16) == "hopper_stream"
    before = dict(fused_gn_afno.launches_by_path)
    got = fused_gn_afno(*args, approximate=True).numpy()
    assert fused_gn_afno.launches_by_path == before
    ja = jax_args(c)
    ref = jax.jit(_xla_reference, static_argnames=("K", "groups"))
    want = np.asarray(ref(*ja[:9], K=ja[9], groups=ja[10]))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# two trunk blocks of 128 channels (M's block size), 2 blocks, GroupNorm(8),
# patch 8 and modes 32 as configs/pretrain_medium.yaml, on 64^2 and 256^2
STREAM_WIDTHS = dict(patch_size=8, in_channels=3, out_channels=3, in_timesteps=4,
                     out_timesteps=1, embed_dim=256, depth=2, n_blocks=2, mlp_ratio=1.0,
                     modes=32, n_cls=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("res", [64, 256])
def test_two_layers_at_the_slice_grids_match_jax(res, dtype, tmp_path):
    """The port's model, its weights written as a reference .pth and
    carried into a fresh model by train/interop.py `params_from_any`,
    against the JAX model on the same weights: f32 at the interop bar
    (2e-4 absolute), bf16 at the bf16 model bar (relative L2 below 2e-2:
    the two packages round at different points). Its bf16 blocks take the
    stream path on the card."""
    import jax
    import jax.numpy as jnp

    from dpot_tpu.models import build_model as jax_build_model
    from dpot_tpu_torch.models import build_model
    from dpot_tpu_torch.train.interop import params_from_any

    cfg = dict(STREAM_WIDTHS, img_size=res)
    h = res // 8
    K = h * (h // 2 + 1)
    assert kernel_path(1, h * h, 256, K, 2, 8, BF16) == "hopper_stream"
    path = tmp_path / "model.pth"
    torch.save({"model": build_model("DPOT", device="cpu", seed=43, **cfg).state_dict()}, path)
    tdt, jdt = (torch.bfloat16, jnp.bfloat16) if dtype == "bfloat16" else (F32, jnp.float32)
    tm = build_model("DPOT", dtype=tdt, device="cpu", seed=44, **cfg)
    tm.load_state_dict(params_from_any(str(path), tm), strict=True)
    x = rand_x((1, res, res, 4, 3), seed=45)
    with torch.no_grad():
        ty, tc = (t.numpy() for t in tm(torch.from_numpy(x)))
    jm = jax_build_model("DPOT", dtype=jdt, **cfg)
    apply = jax.jit(jm.apply)  # one compile instead of one an op
    jy, jc = (np.asarray(t) for t in apply(jax_params(tm, 2, False), jnp.asarray(x)))
    assert ty.shape == jy.shape == (1, res, res, 1, 3) and np.isfinite(ty).all()
    if dtype == "float32":
        np.testing.assert_allclose(ty, jy, atol=2e-4, rtol=0)
        np.testing.assert_allclose(tc, jc, atol=2e-4, rtol=0)
    else:
        assert np.linalg.norm(ty - jy) / np.linalg.norm(jy) < 2e-2
