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
    before (a file sees those of the files it includes: afno_hopper_f32.cu
    for the f32 ones, hopper_tma.cuh and afno_hopper_stream.cu for the bf16
    one)."""
    src = (build.SRC_DIR / name).read_text()
    if '#include "afno_hopper_f32.cu"' in src:
        src = (build.SRC_DIR / "afno_hopper_f32.cu").read_text() + src
    if '#include "afno_hopper_stream.cu"' in src:
        src = "".join((build.SRC_DIR / f).read_text()
                      for f in ("hopper_tma.cuh", "afno_hopper_stream.cu")) + src
    out: dict[str, int] = {}
    for m in re.finditer(r"^constexpr int (\w+) = ([^;]+);", src, re.MULTILINE):
        out[m[1]] = eval(m[2].replace("/", "//"), {}, dict(out))
    return out


SMEM_LIMIT = 232448  # 227 KB, what a CTA may have on the H100
SMS = 132            # the H100's SMs: the persistent grid's size at most


def _bf16_plan() -> dict[str, int]:
    return _constants("afno_hopper_l.cu")


def _l_source() -> str:
    return (build.SRC_DIR / "afno_hopper_l.cu").read_text()


def _spectral_body() -> str:
    src = _l_source()
    body = src[src.index("\nspectral_l_kernel("):]
    return body[:body.index("\n}\n")]


def test_bf16_shared_memory_plan_fits_a_cta():
    """The shared-memory plan of afno_hopper_l.cu's persistent spectral CTA,
    mirrored here: the resident A rows of a 64-mode chunk at the largest
    admitted latent (re and im, four 64-px k-blocks of 64 x 64), the
    resident W1 and W2 of a block (each part a [96 out][64 in] box with the
    128-byte swizzle and a [96 out][32 in] box with the 64-byte one), the
    z/h/o tile [z_re | z_im] (three 64-column k-blocks) and the x ring
    (stages of three 32-channel x 64-px boxes, at least three deep) sit one
    after another, every TMA box at a 1024-byte swizzle atom; the
    mbarriers (two a ring stage, two each for A and W) follow; the whole
    stays within the 227 KB (232,448 bytes) a CTA may have."""
    c = _bf16_plan()
    bs, box, px, mc = c["L_BS"], c["BOX"], c["PX"], c["MC"]
    assert (bs, c["L_MAX_HW"], px, mc, c["NT"], c["NC"]) == (96, 256, 64, 64, 288, 256)
    assert box == 64 * 128 and c["L_NKX"] == c["L_MAX_HW"] // px == 4
    assert c["XBOX"] == 32 * px * 2 and c["X_STAGE"] == 3 * c["XBOX"] == px * bs * 2
    assert c["A_BYTES"] == 2 * c["L_NKX"] * mc * 128
    assert c["WQ0"] == bs * 64 * 2 and c["WQ1"] == bs * 32 * 2
    assert c["W_PART"] == c["WQ0"] + c["WQ1"] and c["W_LAYER"] == 2 * c["W_PART"]
    assert 2 * c["W_LAYER"] == 2 * 2 * bs * bs * 2  # W1 and W2 exactly: no padded inputs
    assert c["ZH_BYTES"] == 3 * box and 3 * 64 == 2 * bs
    spans = [(c["L_A_OFF"], c["A_BYTES"]), (c["L_W_OFF"], 2 * c["W_LAYER"]),
             (c["L_Z_OFF"], c["ZH_BYTES"]), (c["L_X_OFF"], c["L_NS"] * c["X_STAGE"]),
             (c["L_MISC"], 8 * (2 * c["L_NS"] + 4))]
    assert spans[0][0] == 0
    for (a, n), (b, _) in zip(spans, spans[1:]):
        assert a + n == b
    assert 8 * (2 * c["L_NS"] + 4) <= 128 and c["L_NS"] >= 3
    assert c["L_SMEM"] == c["L_MISC"] + 128 + 1024 <= SMEM_LIMIT == c["SMEM_MAX"]
    boxes = ([c["L_A_OFF"] + (p * c["L_NKX"] + k) * box for p in range(2)
              for k in range(c["L_NKX"])]
             + [c["L_W_OFF"] + layer * c["W_LAYER"] + p * c["W_PART"] + q * c["WQ0"]
                for layer in range(2) for p in range(2) for q in range(2)]
             + [c["L_X_OFF"] + s * c["X_STAGE"] + h * c["XBOX"] for s in range(c["L_NS"])
                for h in range(3)]
             + [c["L_Z_OFF"] + k * box for k in range(3)])
    assert all(off % 1024 == 0 for off in boxes)
    # the registers a consumer thread holds for an m64 x n96 accumulator
    # (z, then h and o), within what a 288-thread CTA leaves a thread
    assert 64 * bs // 128 == 48 <= 65536 // c["NT"] - 64


def _admitted_bf16_shapes():
    return ([preset_shapes("L", B) for B in (1, 8, 16, 20)]
            + [(B, 256, 768, 144, 8, 4) for B in (1, 4, 16)]  # a TP rank's share
            + ADMITTED_L_EDGES[BF16])


def walk(B, HW, C, K, nb, groups, drop=False, sms=SMS):
    """The persistent spectral launch's walk, as afno_hopper_l.cu's run_l
    and spectral_l_kernel compute it: T = nb nch B tiles, nch = ceil(K / 64)
    mode chunks (one less in the control), a grid of min(T, sms) CTAs, CTA i
    walking tiles [i T / G, (i + 1) T / G), tile t being (chunk t / B % nch,
    block t / (nch B), sample t % B). Returns each CTA's tiles and its
    count of A and W loads (a new chunk's rows, a new block's weights)."""
    mc = _bf16_plan()["MC"]
    nch = -(-K // mc) - drop
    T = nb * nch * B
    G = min(T, sms)
    ctas = []
    for i in range(G):
        tiles, na, nw = [], 0, 0
        for t in range(i * T // G, (i + 1) * T // G):
            j, c, b = t // (nch * B), t // B % nch, t % B
            na += not tiles or c != tiles[-1][0]
            nw += not tiles or j != tiles[-1][1]
            tiles.append((c, j, b))
        ctas.append((tiles, na, nw))
    return ctas, nch


@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("shapes", _admitted_bf16_shapes())
def test_the_walk_covers_each_tile_once(shapes, drop):
    """At L, a TP rank's C = 768 and every edge shape the gate admits, the
    persistent CTAs' contiguous ranges cover each (chunk, block, sample)
    tile exactly once, the grid fills at most the card's SMs and gives
    every CTA a tile, and no CTA walks more than one tile beyond another;
    the control leaves out exactly the last chunk's tiles (refused where K
    is one chunk)."""
    B, HW, C, K, nb, groups = shapes
    mc = _bf16_plan()["MC"]
    full = -(-K // mc)
    if drop and full == 1:
        assert "if (nch < 1) return cudaErrorInvalidValue;" in _l_source()
        return
    ctas, nch = walk(*shapes, drop=drop)
    assert nch == full - drop >= 1
    seen = [tile for tiles, _, _ in ctas for tile in tiles]
    assert sorted(seen) == sorted((c, j, b) for c in range(nch) for j in range(nb)
                                  for b in range(B))
    assert len(ctas) == min(nb * nch * B, SMS) and all(tiles for tiles, _, _ in ctas)
    sizes = [len(tiles) for tiles, _, _ in ctas]
    assert max(sizes) - min(sizes) <= 1
    for tiles, na, nw in ctas:  # the resident operands change only where the walk does
        assert na == 1 + sum(a[0] != b[0] for a, b in zip(tiles, tiles[1:]))
        assert nw == 1 + sum(a[1] != b[1] for a, b in zip(tiles, tiles[1:]))


@pytest.mark.parametrize("B,loads", [(1, (48, 48)), (8, (156, 140)), (16, (168, 144)),
                                     (20, (168, 144))])
def test_the_walk_reloads_what_the_source_reckons(B, loads):
    """The L2 reckoning in afno_hopper_l.cu's header: at DPOT-L the walk
    (j, c, b) loads a chunk's A rows and a block's weights as often as the
    header counts them (B = 8: 156 and 140 times, 39.4 MB with the x
    tiles, against 125.8 MB of the design before)."""
    ctas, nch = walk(*preset_shapes("L", B))
    c = _bf16_plan()
    na, nw = sum(a for _, a, _ in ctas), sum(w for _, _, w in ctas)
    assert (na, nw) == loads
    tiles = sum(len(t) for t, _, _ in ctas)
    mb = (tiles * 256 * c["X_STAGE"] // c["PX"] + na * c["A_BYTES"]
          + nw * 2 * c["W_LAYER"]) / 1e6
    if B == 8:
        header = re.sub(r"\n// ?", " ", _l_source())
        assert round(mb, 1) == 39.4 and "39.4 MB against the design before's 125.8 MB" in header


@pytest.mark.parametrize("K", range(4, 161, 4))
def test_the_chunks_cover_every_admitted_k(K):
    """Every K the gate admits (a multiple of 4 up to 160) is one to three
    64-mode chunks whose last one holds 1 to 64 of them; the o stores keep
    the rows below K; the control keeps every mode below the last chunk
    and leaves out at least one."""
    mc = _bf16_plan()["MC"]
    assert hopper_l_supported(2, 256, 1536, K, 16, 8, BF16)
    nch = -(-K // mc)
    assert 1 <= nch <= 3 and 0 < K - (nch - 1) * mc <= mc
    if nch > 1:
        kept = (nch - 1) * mc
        assert 0 < kept < K
    src = _l_source()
    assert "const int nch = (K + MC - 1) / MC - (drop ? 1 : 0);" in src
    assert "rows = K - m0 < MC ? K - m0 : MC;" in src


@pytest.mark.parametrize("HW", [128, 256])
@pytest.mark.parametrize("cpg", [96, 192])
def test_the_statistics_launch_deals_whole_8_channel_columns(cpg, HW):
    """The statistics launch (l_stats_kernel, STATS_NT threads a group
    and sample) deals each thread one 8-channel column of the group and
    every rstep-th row, at most L_STATS_ROWS rows (all loaded at once),
    covering the group's HW x cpg values exactly once; the spectral
    consumers' normaliser deals 12 columns x 16 rows of an x stage's 96
    channels x 64 px, 4 rows a thread, each thread's 8 channels inside one
    group."""
    c = _bf16_plan()
    nt, cols = c["STATS_NT"], cpg // 8
    assert cpg % 8 == 0 and cols <= nt
    rstep = nt // cols
    cells = [(tid % cols, p) for tid in range(nt) if tid // cols < rstep
             for p in range(tid // cols, HW, rstep)]
    assert sorted(cells) == [(col, p) for col in range(cols) for p in range(HW)]
    assert max(len(range(r, HW, rstep)) for r in range(rstep)) <= c["L_STATS_ROWS"]
    assert c["L_STATS_ROWS"] * (nt // 24) >= c["L_MAX_HW"]
    assert c["L_NORM_T"] == 12 * 16 <= c["NC"] and c["L_BS"] == 12 * 8
    norm = sorted((tid % 12, tid // 12 + 16 * k) for tid in range(c["L_NORM_T"])
                  for k in range(4))
    assert norm == [(col, p) for col in range(12) for p in range(c["PX"])]
    for j in range(16):
        for lc in range(12):
            assert len({(j * 96 + 8 * lc + e) // cpg for e in range(8)}) == 1


@pytest.mark.parametrize("HW", [128, 256])
def test_the_ring_holds_a_tile_and_the_next_tiles_first_stage(HW):
    """The x ring holds a whole tile's 64-px stages and at least one of the
    next tile's, which the consumers normalise while the tile before runs
    its first MLP layer (the next tile's other stages land once this tile's
    analysis hands its own back, and are normalised under the second);
    each stage slot is a whole multiple of the 64-byte swizzle's 512-byte
    atom."""
    c = _bf16_plan()
    nkx = HW // c["PX"]
    assert c["L_NS"] >= c["L_NKX"] + 1 >= nkx + 1
    assert c["X_STAGE"] % 512 == 0 and c["XBOX"] % 512 == 0
    body = _spectral_body()
    assert "if (!last) normalise(it);" in body
    assert "for (int q = 1; q < nkx; ++q) normalise(it + q);" in body


@pytest.mark.parametrize("shapes", _admitted_bf16_shapes())
def test_l_tensor_map_strides_are_16_byte_multiples(shapes):
    """Every tensor map of the three launches at every admitted shape: the
    global strides of x and out (B, HW, C), A (2, K, HW), the weights (2,
    nb, 96, 96), Ainv (HW, 2K) and o (B, 2K, C), all bf16, are multiples of
    16 bytes; each box is at most 256 elements a side with an inner side of
    64 bytes under the 64-byte swizzle (x's 32-channel boxes, the weights'
    last 32 inputs) or 128 bytes under the 128-byte one."""
    B, HW, C, K, nb, groups = shapes
    maps = {"x": (C, HW, B), "A": (HW, K, 2), "w": (96, 96, nb, 2), "Ainv": (2 * K, HW),
            "o": (C, 2 * K, B)}
    for name, dims in maps.items():
        stride = 2
        for d in dims[:-1]:
            stride *= d
            assert stride % 16 == 0, (name, dims)
    c = _bf16_plan()
    sw64 = [(32, c["PX"], 1), (32, c["L_BS"], 1, 1)]
    sw128 = [(c["PX"], c["MC"], 1), (64, c["L_BS"], 1, 1), (64, c["SYN_P"], 1),
             (64, c["SYN_K"], 1), (c["SYN_K"], c["SYN_P"])]
    for box in sw64 + sw128:
        assert max(box) <= 256
    assert all(b[0] * 2 == 64 for b in sw64) and all(b[0] * 2 == 128 for b in sw128)
    assert HW % c["PX"] == 0 and HW % c["SYN_P"] == 0 and C % 64 == 0


def test_the_bf16_source_is_persistent_warp_specialised_and_reads_no_group():
    """spectral_l_kernel has a producer warp (the threads past NC) issuing
    every TMA load, consumers that wait on mbarriers and run wgmma (the
    analysis MN-major from the 64-byte-swizzled x stages), a loop over its
    range of tiles, and no statistics pass: the statistics come from
    l_stats_kernel, launched once a call, which the spectral launch waits
    for (wait_primary); the synthesis is the streamed one. The source includes afno_hopper_stream.cu's parts
    without its entry points."""
    src, body = _l_source(), _spectral_body()
    assert '#define AFNO_HOPPER_STREAM_PARTS\n#include "afno_hopper_stream.cu"' in src
    stream = (build.SRC_DIR / "afno_hopper_stream.cu").read_text()
    assert "#ifndef AFNO_HOPPER_STREAM_PARTS" in stream
    assert stream.index("#ifndef AFNO_HOPPER_STREAM_PARTS") < stream.index(
        'extern "C" int dpot_afno_hopper_stream_supported(')
    assert "if (tid >= NC) {" in body and "for (int t = t0; t < t1; ++t) {" in body
    for part in ("tma_load_3d", "tma_load_4d", "mbar_wait", "mbar_expect_tx", "release(",
                 "mma<1, 1>", "wait_primary();", "desc64("):
        assert part in body, part
    for gone in ("cta_sum", "__ldg(reinterpret_cast<const uint4*>", "mma.sync", "cp.async.cg"):
        assert gone not in body, gone
    assert src.count("l_stats_kernel<<<") == 1 and "stream_stats_kernel<<<" not in src
    assert "launch_synthesis_tn<" in src and "launch_synthesis(" not in src
    for entry in ("dpot_afno_hopper_l(", "dpot_afno_hopper_l_supported(",
                  "dpot_afno_hopper_l_drop_last_chunk("):
        assert f'extern "C" int {entry}' in src


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
