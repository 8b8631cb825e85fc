"""Ragged latents and odd K on the Hopper kernels of the fused op
(dpot_tpu_torch/ops/cuda/afno_fused.py) on the CPU: the streamed bf16 kernel
(afno_hopper_stream.cu) and the f32 kernels (afno_hopper_f32{,_l,_wide}.cu)
take every latent up to 4096 pixels and every K. They work on whole 64-pixel
tiles and a count of modes that is a multiple of 4, on copies of A and Ainv
padded with zeros (`padded_ops`), mask the x rows past HW, take the GroupNorm statistics over
the HW real rows and store only those rows. DPOT-M at res 96 (a 12^2 latent,
K 84), 72 (9^2, K 45), 80, 160 and 192, and at res 64 with patch 16 (4^2, K
12), all left on the five-launch afno_fused.cu before.

Checked here: no preset and no config's widths reach the five-launch kernel
at those grids; the padded copies, their cache and its rule under capture;
the padded arithmetic, emulated in torch, against the plain version on the
unpadded operators; and the plain version and a two-layer model at the new
latents against the JAX package. The kernels run only on the card
(tests/test_torch_gpu.py -k ragged, chip_smoke.py).
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from dpot_tpu_torch.ops.cuda import afno_fused
from dpot_tpu_torch.ops.cuda.afno_fused import (
    _act,
    fused_gn_afno,
    fused_gn_afno_ref,
    kernel_path,
    padded_dims,
    padded_ops,
)
from dpot_tpu_torch.ops.spectral import combined_spectral_ops, complex_as_real_weight, kept_modes
from test_torch_afno_hopper import preset_shapes
from test_torch_afno_kernel import jax_args, make_case, port_args
from test_torch_afno_stream import STREAM_WIDTHS
from test_torch_model import jax_params, rand_x

BF16, F32 = torch.bfloat16, torch.float32
CONFIGS = Path(__file__).resolve().parent.parent / "configs"


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test files at once, some of them timing host
    throughput; torch's CPU ops here keep to two threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def single_shapes(B: int = 1, res: int = 128, patch: int = 8) -> tuple:
    """(B, HW, C, K, nb, groups) of one trunk block of
    configs/afno_config_single.yaml's model (width 512, 8 blocks of 64,
    modes 32, GroupNorm(8)) at res^2."""
    cfg = yaml.safe_load((CONFIGS / "afno_config_single.yaml").read_text())
    h = res // patch
    kh, kw = kept_modes(h, h, cfg["modes"])
    return B, h * h, cfg["width"], kh * kw, cfg["n_blocks"], 8


# every grid a CLI may ask for at patch 8, and two at patch 16
GRIDS = [(r, 8) for r in (64, 72, 80, 96, 128, 160, 192, 256)] + [(64, 16), (128, 16)]
# the kernel each model's blocks take where the latent is not 128 or 256 px
# with K a multiple of 4 (the bf16 kernels for whole slabs), by type
WANT = {BF16: {"Ti": "hopper_stream", "S": "hopper_stream", "M": "hopper_stream",
               "L": "hopper_stream", "H": "hopper_stream", "single": "hopper_stream"},
        F32: {"Ti": "hopper_f32", "S": "hopper_f32", "M": "hopper_f32", "L": "hopper_f32_l",
              "H": "hopper_f32_wide", "single": "hopper_f32_pairs"}}
WANT_SLAB = {"Ti": "hopper", "S": "hopper", "M": "hopper", "L": "hopper_l",
             "H": "hopper_wide", "single": "hopper_pairs"}


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("res,patch", GRIDS)
@pytest.mark.parametrize("name", ["Ti", "S", "M", "L", "H", "single"])
def test_no_preset_reaches_the_five_launch_kernel(name, res, patch, dtype):
    """Ti, S, M, L, H and configs/afno_config_single.yaml's widths at every
    grid above, in bf16 and f32, at a batch of 1 and of 20: a Hopper kernel,
    never "general". bf16 at a 16^2 latent (res 128, patch 8) keeps the
    kernels that hold whole slabs; every other bf16 grid takes the streamed
    kernel, every f32 grid the f32 kernel of the block size."""
    for B in (1, 20):
        if name == "single":
            shapes = single_shapes(B, res, patch)
        else:
            shapes = preset_shapes(name, B, res=res, patch=patch)
        path = kernel_path(*shapes, dtype)
        assert path != "general", shapes
        slab = dtype == BF16 and (res, patch) == (128, 8)
        assert path == (WANT_SLAB[name] if slab else WANT[dtype][name]), shapes


@pytest.mark.parametrize("res,patch,HW,K", [(96, 8, 144, 84), (80, 8, 100, 60),
                                            (160, 8, 400, 220), (72, 8, 81, 45),
                                            (64, 16, 16, 12)])
def test_the_slice_latents(res, patch, HW, K):
    """DPOT-M's latents at the slice's grids (patch 8 or 16, modes 32) and
    the padded operators' sizes there."""
    _, hw, C, k, nb, groups = preset_shapes("M", 20, res=res, patch=patch)
    assert (hw, k, C, nb, groups) == (HW, K, 1024, 8, 8)
    HWp, Kp = padded_dims(HW, K)
    assert HWp % 64 == 0 and HWp - 64 < HW <= HWp
    assert Kp % 4 == 0 and K <= Kp < K + 4


@pytest.mark.parametrize("K,Kp", [(45, 48), (40, 40), (84, 84), (220, 220), (544, 544),
                                  (66, 68), (12, 12), (9, 12), (2, 4), (543, 544), (142, 144)])
def test_padded_dims_rounds_k_to_a_multiple_of_4(K, Kp):
    """K rounds up to a multiple of 4, so that Ainv's bf16 rows (4 Kp bytes)
    are whole 16-byte units, which a tensor map's strides must be (the
    streamed kernel reads Ainv through one); K 45 (res 72) pads to 48, K 66
    (an 11^2 latent) to 68; DPOT-M's K 40, 84, 220 and 544 stay as they
    are. The f32 kernels read the same padded copies."""
    assert padded_dims(1024, K) == (1024, Kp)
    assert padded_dims(81, K) == (128, Kp)


# (H, W, modes): ragged latents, odd K, both, and one that needs no padding
OPS_CASES = [(12, 12, 32), (9, 9, 32), (20, 20, 32), (4, 4, 32), (10, 10, 32), (16, 16, 3),
             (8, 8, 4)]


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("H,W,modes", OPS_CASES)
def test_padded_copies_are_zero_where_they_must_be(H, W, modes, dtype):
    """A (2Kp, HWp): A's rows at columns below HW, zero columns past HW and
    zero rows at the padded modes K .. Kp - 1 in both halves; Ainv (HWp,
    2Kp) the same transposed. Where nothing is padded, A and Ainv
    themselves."""
    kh, kw = kept_modes(H, W, modes)
    K, HW = kh * kw, H * W
    A, Ainv = combined_spectral_ops(H, W, kh, kw, dtype, torch.device("cpu"))
    Ap, Ainvp = padded_ops(A, Ainv, K)
    HWp, Kp = padded_dims(HW, K)
    if (HWp, Kp) == (HW, K):
        assert Ap is A and Ainvp is Ainv
        return
    assert Ap.shape == (2 * Kp, HWp) and Ainvp.shape == (HWp, 2 * Kp)
    assert Ap.dtype == Ainvp.dtype == dtype and Ap.is_contiguous() and Ainvp.is_contiguous()
    for half in (0, 1):  # real, imaginary parts
        rows = slice(half * Kp, half * Kp + K)
        assert torch.equal(Ap[rows, :HW], A[half * K:(half + 1) * K])
        assert torch.equal(Ainvp[:HW, rows], Ainv[:, half * K:(half + 1) * K])
        pad = slice(half * Kp + K, (half + 1) * Kp)  # the padded modes, if any
        assert not Ap[pad].any() and not Ainvp[:, pad].any()
    assert not Ap[:, HW:].any() and not Ainvp[HW:].any()


def test_padded_copies_are_cached_on_the_operator():
    """Made once per operator pair and kept on A: the same tensors on every
    call (a CUDA graph reads them by address); made again after an
    in-place change of A; made outside inference mode."""
    A, Ainv = combined_spectral_ops(12, 12, 12, 7, F32, torch.device("cpu"))
    with torch.inference_mode():
        first = padded_ops(A, Ainv, 84)
    assert not first[0].is_inference() and not first[1].is_inference()
    again = padded_ops(A, Ainv, 84)
    assert again[0] is first[0] and again[1] is first[1]
    A2, Ainv2 = A.clone(), Ainv.clone()
    copy = padded_ops(A2, Ainv2, 84)
    assert copy[0] is not first[0] and torch.equal(copy[0], first[0])
    A2.mul_(2.0)
    changed = padded_ops(A2, Ainv2, 84)
    assert changed[0] is not copy[0] and torch.equal(changed[0][:84, :144], A2[:84])


def test_a_miss_under_capture_raises(monkeypatch):
    """A CUDA graph cannot make the copies during its capture: a miss
    raises there, a hit returns the cached copies (the capture's warm-up
    made them)."""
    A, Ainv = combined_spectral_ops(9, 9, 9, 5, F32, torch.device("cpu"))
    A, Ainv = A.clone(), Ainv.clone()  # operators no earlier test padded
    monkeypatch.setattr(afno_fused, "capturing", lambda: True)
    with pytest.raises(RuntimeError, match="capture"):
        padded_ops(A, Ainv, 45)
    monkeypatch.setattr(afno_fused, "capturing", lambda: False)
    made = padded_ops(A, Ainv, 45)
    monkeypatch.setattr(afno_fused, "capturing", lambda: True)
    assert padded_ops(A, Ainv, 45)[0] is made[0]


def padded_emulation(x, gscale, gbias, Ap, Ainvp, w1, b1, w2, b2, K, groups,
                     approximate=True, act="gelu"):
    """What the streamed and f32 kernels compute on the padded operators,
    in torch ops, rounding where they round: x's rows past HW zero (as
    cp.async with a source size of 0 leaves them), the GroupNorm statistics
    over the HW real rows, xn (padded rows too) rounded to x's dtype, z =
    Ap . xn over all HWp pixels, the mode MLP over all Kp modes (the padded
    mode's z is zero), o rounded, y = Ainvp . o, and rows below HW of y +
    xn stored."""
    cd = x.dtype
    B, HW, C = x.shape
    HWp, Kp = Ainvp.shape[0], Ap.shape[0] // 2
    nb = w1.shape[1]
    bs = C // nb

    def rnd(t):
        return t.to(cd).float()

    xp = torch.zeros((B, HWp, C), dtype=torch.float32)
    xp[:, :HW] = x.float()
    xg = xp[:, :HW].reshape(B, HW, groups, C // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    rstd = torch.rsqrt(xg.var(dim=(1, 3), unbiased=False, keepdim=True) + 1e-5)
    cols = lambda t: t.expand(B, 1, groups, C // groups).reshape(B, 1, C)  # noqa: E731
    xn32 = (xp - cols(mean)) * cols(rstd) * gscale + gbias        # (B, HWp, C)
    z = rnd(torch.matmul(Ap.float(), rnd(xn32)))                    # (B, 2Kp, C)
    zj = torch.cat([z[:, :Kp].reshape(B, Kp, nb, bs), z[:, Kp:].reshape(B, Kp, nb, bs)], -1)
    W1 = rnd(complex_as_real_weight(w1[0], w1[1]))
    W2 = rnd(complex_as_real_weight(w2[0], w2[1]))
    h = rnd(_act(act, approximate)(torch.einsum("bkji,jio->bkjo", zj, W1)
                                   + torch.cat([b1[0], b1[1]], -1)))
    o = torch.einsum("bkji,jio->bkjo", h, W2) + torch.cat([b2[0], b2[1]], -1)
    ob = rnd(torch.cat([o[..., :bs].reshape(B, Kp, C), o[..., bs:].reshape(B, Kp, C)], 1))
    y = torch.matmul(Ainvp.float(), ob) + xn32
    return y[:, :HW].to(cd)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("H,W,modes,C,nb,groups", [
    (12, 12, 32, 256, 2, 8),    # M's 12^2 latent (res 96), blocks of 128
    (9, 9, 32, 256, 2, 8),      # 9^2 (res 72): 81 px and K 45, both padded
    (4, 4, 32, 192, 2, 2),      # 4^2 (res 64, patch 16): 16 px, blocks of 96
    (10, 10, 32, 256, 1, 4),    # 10^2 (res 80): one block of 256
    (16, 16, 3, 128, 1, 16),    # 256 px, modes 3: K 9, odd
])
def test_padded_arithmetic_matches_the_plain_version(H, W, modes, C, nb, groups, dtype):
    """The kernels' arithmetic on the padded operators, emulated in torch,
    against fused_gn_afno_ref on the unpadded ones: within 1e-6 of the
    output's magnitude in f32 (the zero products are exact; what differs is
    the order of the f32 sums, a few f32 ulps) and within one bf16 ulp of it
    in bf16, where a rounding of z, h or o may fall the other way for the
    same reason."""
    c = make_case(B=2, H=H, W=W, C=C, nb=nb, modes=modes, groups=groups, seed=61)
    args = port_args(c, dtype)
    x, gs, gb, A, Ainv, w1, b1, w2, b2, K, groups = args
    assert padded_dims(H * W, K) != (H * W, K)
    Ap, Ainvp = padded_ops(A, Ainv, K)
    approx = dtype == BF16
    got = padded_emulation(x, gs, gb, Ap, Ainvp, w1, b1, w2, b2, K, groups, approx).float()
    want = fused_gn_afno_ref(*args, approximate=approx).float()
    assert got.shape == want.shape == (2, H * W, C)
    lim = (1e-6 if dtype == F32 else 2.0 ** -7) * want.abs().max().item()
    assert (got - want).abs().max().item() <= lim


def test_the_padded_entries_are_read():
    """The smoke's control: one nonzero entry in A's padded columns (and,
    for an odd K, in Ainv's padded mode column) moves the emulated output
    far past the kernel check's limits, so a kernel that reads the padded
    operators is held to their zeros."""
    c = make_case(B=2, H=9, W=9, C=256, nb=2, modes=32, groups=8, seed=62)
    x, gs, gb, A, Ainv, w1, b1, w2, b2, K, groups = port_args(c, F32)
    Ap, Ainvp = (t.clone() for t in padded_ops(A, Ainv, K))
    want = fused_gn_afno_ref(x, gs, gb, A, Ainv, w1, b1, w2, b2, K, groups, False)
    for which in ("A", "Ainv"):
        a, ai = Ap.clone(), Ainvp.clone()
        if which == "A":
            a[0, 81] = 1.0       # a padded pixel's column
        else:
            ai[0, K] = 1.0       # the padded mode K's column
        got = padded_emulation(x, gs, gb, a, ai, w1, b1, w2, b2, K, groups, False)
        assert (got - want).abs().max().item() > 1e-3, which


@pytest.mark.parametrize("H", [12, 9])
def test_plain_version_matches_the_xla_reference_at_the_ragged_latents(H):
    """The yardstick of the kernels at (HW 144, K 84) and (HW 81, K 45),
    against the JAX package's `_xla_reference` in f32 (tanh-GELU): 1e-5
    absolute, the same f32 arithmetic in another order. On the CPU the
    wrapper runs this plain version and launches nothing."""
    import jax

    from dpot_tpu.ops.pallas.afno_fused import _xla_reference

    c = make_case(B=1, H=H, W=H, C=256, nb=2, modes=32, groups=8, seed=63)
    args = port_args(c)
    assert args[9] == {12: 84, 9: 45}[H]
    for dtype in (BF16, F32):
        assert kernel_path(1, H * H, 256, args[9], 2, 8, dtype) != "general"
    before = dict(fused_gn_afno.launches_by_path)
    got = fused_gn_afno(*args, approximate=True).numpy()
    assert fused_gn_afno.launches_by_path == before
    ja = jax_args(c)
    ref = jax.jit(_xla_reference, static_argnames=("K", "groups"))
    want = np.asarray(ref(*ja[:9], K=ja[9], groups=ja[10]))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("res", [96, 72])
def test_two_layers_at_the_ragged_grids_match_jax(res, dtype, tmp_path):
    """Two trunk blocks of M's block size (STREAM_WIDTHS: patch 8, modes 32)
    on 96^2 and 72^2 grids: the port's model, its weights carried through a
    reference .pth (`params_from_any`), against the JAX model on the same
    weights: f32 at 2e-4 absolute, bf16 within 2e-2 relative L2. Its
    blocks take the streamed kernel in bf16 and the f32 kernel in f32 on
    the card."""
    import jax
    import jax.numpy as jnp

    from dpot_tpu.models import build_model as jax_build_model
    from dpot_tpu_torch.models import build_model
    from dpot_tpu_torch.train.interop import params_from_any

    cfg = dict(STREAM_WIDTHS, img_size=res)
    h = res // 8
    K = h * (h // 2 + 1)
    tdt, jdt = (BF16, jnp.bfloat16) if dtype == "bfloat16" else (F32, jnp.float32)
    assert kernel_path(1, h * h, 256, K, 2, 8, tdt) == (
        "hopper_stream" if tdt == BF16 else "hopper_f32")
    path = tmp_path / "model.pth"
    torch.save({"model": build_model("DPOT", device="cpu", seed=46, **cfg).state_dict()}, path)
    tm = build_model("DPOT", dtype=tdt, device="cpu", seed=47, **cfg)
    tm.load_state_dict(params_from_any(str(path), tm), strict=True)
    x = rand_x((1, res, res, 4, 3), seed=48)
    with torch.no_grad():
        ty, tc = (t.float().numpy() for t in tm(torch.from_numpy(x)))
    jm = jax_build_model("DPOT", dtype=jdt, **cfg)
    apply = jax.jit(jm.apply)
    jy, jc = (np.asarray(t, np.float32) for t in apply(jax_params(tm, 2, False), jnp.asarray(x)))
    assert ty.shape == jy.shape == (1, res, res, 1, 3) and np.isfinite(ty).all()
    if dtype == "float32":
        np.testing.assert_allclose(ty, jy, atol=2e-4, rtol=0)
        np.testing.assert_allclose(tc, jc, atol=2e-4, rtol=0)
    else:
        assert np.linalg.norm(ty - jy) / np.linalg.norm(jy) < 2e-2

