"""Tests of the port that need the card: each hand-written CUDA kernel
against its plain PyTorch version, on CUDA tensors, and the gradient of the
fused op against autograd through its plain version. They skip without a CUDA
device. The module imports neither JAX nor the JAX package, so on a machine
with the card it runs alone:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from dpot_tpu_torch.ops import bias_act as bias_act_op
from dpot_tpu_torch.ops.cuda import afno_fused
from dpot_tpu_torch.ops.cuda.afno_fused import fused_gn_afno, fused_gn_afno_ref
from dpot_tpu_torch.ops.cuda.bias_act import bias_act
from dpot_tpu_torch.ops.spectral import combined_spectral_ops, kept_modes


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def ti_block_args(B, dtype, device, seed=11, H=16, W=16, C=512, nb=4, modes=32,
                  groups=8):
    """fused_gn_afno arguments, by default at the DPOT-Ti block shapes (16x16
    latent, C 512, 4 blocks, modes 32), seeded with numpy."""
    bs = C // nb
    kh, kw = kept_modes(H, W, modes)
    rng = np.random.default_rng(seed)

    def t(shape, scale=1.0, shift=0.0, dt=torch.float32):
        a = (shift + scale * rng.standard_normal(shape)).astype(np.float32)
        return torch.from_numpy(a).to(device, dt)

    A, Ainv = combined_spectral_ops(H, W, kh, kw, dtype, device)
    return (t((B, H * W, C), dt=dtype), t((C,), 0.1, 1.0), t((C,), 0.1), A, Ainv,
            t((2, nb, bs, bs), 0.05), t((2, nb, bs), 0.05),
            t((2, nb, bs, bs), 0.05), t((2, nb, bs), 0.05), kh * kw, groups)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_gn_afno_matches_plain_version(cuda, dtype, B):
    """f32: summation order only (5e-5 absolute). bf16: a few bf16 ulps of
    the output's magnitude, where one rounding of z, h or o falls the other
    way (4 ulps = 4 * 2^-7 * max|out|)."""
    args = ti_block_args(B, dtype, cuda)
    approx = dtype == torch.bfloat16
    before = fused_gn_afno.launches
    got = fused_gn_afno(*args, approximate=approx).float()
    want = fused_gn_afno_ref(*args, approximate=approx).float()
    torch.cuda.synchronize()
    assert fused_gn_afno.launches == before + 1
    assert torch.isfinite(got).all()
    lim = 5e-5 if dtype == torch.float32 else 4 * 2.0**-7 * want.abs().max().item()
    assert (got - want).abs().max().item() <= lim


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [
    dict(H=8, W=8, C=96, nb=4, modes=3, groups=8),   # 2K = 18: ragged DFT rows
    dict(H=4, W=12, C=40, nb=2, modes=5, groups=4),  # bs = 20: unaligned blocks
])
def test_fused_gn_afno_ragged_shapes_match_plain_version(cuda, dtype, shape):
    """Shapes that leave partial tiles and chunks that are not 16-byte
    aligned, so that every masked load path runs. Tolerances as above."""
    args = ti_block_args(3, dtype, cuda, seed=5, **shape)
    approx = dtype == torch.bfloat16
    got = fused_gn_afno(*args, approximate=approx).float()
    want = fused_gn_afno_ref(*args, approximate=approx).float()
    torch.cuda.synchronize()
    lim = 5e-5 if dtype == torch.float32 else 4 * 2.0**-7 * want.abs().max().item()
    assert (got - want).abs().max().item() <= lim


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 3, 20])
def test_hopper_kernel_matches_plain_version(cuda, B):
    """bf16 at the Ti block shapes takes the two-launch Hopper kernel
    (afno_hopper.cu); against the plain version within 4 bf16 ulps of the
    output's magnitude, as above."""
    args = ti_block_args(B, torch.bfloat16, cuda, seed=20 + B)
    before = dict(fused_gn_afno.launches_by_path)
    got = fused_gn_afno(*args, approximate=True).float()
    want = fused_gn_afno_ref(*args, approximate=True).float()
    torch.cuda.synchronize()
    assert fused_gn_afno.launches_by_path["hopper"] == before["hopper"] + 1
    assert fused_gn_afno.launches_by_path["general"] == before["general"]
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 4 * 2.0**-7 * want.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [
    dict(C=1024, nb=8),                      # S/M width: groups of 128 channels
    dict(H=16, W=8, modes=8),                # 128 px, K 40: one short mode chunk
    dict(H=16, W=8, modes=16),               # 128 px, K 80: a partial second chunk
    dict(H=32, W=8, modes=32),               # K 160: 2K = 320, the most o rows
    dict(modes=2),                           # K 4: 2K = 8
    dict(groups=4),                          # groups of 128 channels at Ti
    dict(groups=16),                         # groups of 32
    dict(groups=64),                         # groups of 8
    dict(C=128, nb=1),                       # one AFNO block
    dict(C=1024, nb=8, groups=128),          # S/M width, groups of 8
])
def test_hopper_kernel_at_admitted_edge_shapes(cuda, shape):
    """Each kind of shape that hopper_supported admits besides Ti runs on
    the Hopper kernel and matches the plain version: 4 bf16 ulps of the
    output's magnitude, as above, and 4e-3 relative L2, as chip_smoke.py
    holds it."""
    args = ti_block_args(2, torch.bfloat16, cuda, seed=41, **shape)
    before = dict(fused_gn_afno.launches_by_path)
    got = fused_gn_afno(*args, approximate=True).float()
    want = fused_gn_afno_ref(*args, approximate=True).float()
    torch.cuda.synchronize()
    assert fused_gn_afno.launches_by_path["hopper"] == before["hopper"] + 1
    assert fused_gn_afno.launches_by_path["general"] == before["general"]
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 4 * 2.0**-7 * want.abs().max().item()
    assert rel_l2(got, want) <= 4e-3


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 3, 20])
def test_hopper_f32_kernel_matches_plain_version(cuda, B):
    """f32 at the Ti block shapes takes the two-launch f32 Hopper kernel
    (afno_hopper_f32.cu, 3xTF32 products); against the plain version within
    5e-5 absolute and 1e-5 relative L2, as chip_smoke.py holds it: 3xTF32
    products are as close to f32 ones as f32 is to f64, so what remains is
    summation order."""
    args = ti_block_args(B, torch.float32, cuda, seed=60 + B)
    before = dict(fused_gn_afno.launches_by_path)
    got = fused_gn_afno(*args, approximate=False)
    want = fused_gn_afno_ref(*args, approximate=False)
    torch.cuda.synchronize()
    assert fused_gn_afno.launches_by_path["hopper_f32"] == before["hopper_f32"] + 1
    assert fused_gn_afno.launches_by_path["general"] == before["general"]
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 5e-5
    assert rel_l2(got, want) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["gelu", "silu"])
@pytest.mark.parametrize("shape", [
    dict(C=1024, nb=8),                      # S/M width: groups of 128 channels
    dict(H=16, W=8, modes=8),                # 128 px, K 40: one partial mode chunk
    dict(H=16, W=8, modes=16),               # 128 px, K 80: a partial third chunk
    dict(H=32, W=8, modes=32),               # K 160: five whole chunks
    dict(modes=2),                           # K 4: 2K = 8, one partial synthesis stage
    dict(H=8, W=8, modes=4),                 # 64 px, K 16: one synthesis pixel tile
    dict(H=32, W=32, modes=12),              # 1024 px, K 144: 32 pixel chunks
    dict(groups=4),                          # groups of 128 channels at Ti
    dict(groups=16),                         # groups of 32
    dict(groups=64),                         # groups of 8
    dict(C=128, nb=1),                       # one AFNO block
    dict(C=1024, nb=8, groups=128),          # S/M width, groups of 8
])
def test_hopper_f32_kernel_at_admitted_edge_shapes(cuda, shape, act):
    """Each kind of shape that hopper_f32_supported admits besides Ti
    (tests/test_torch_afno_f32.py::ADMITTED_F32_EDGES lists the same kinds)
    runs on the f32 Hopper kernel and matches the plain version, with the
    erf-GELU and with silu; tolerances as above."""
    args = ti_block_args(2, torch.float32, cuda, seed=43, **shape)
    before = dict(fused_gn_afno.launches_by_path)
    got = fused_gn_afno(*args, approximate=False, act=act)
    want = fused_gn_afno_ref(*args, approximate=False, act=act)
    torch.cuda.synchronize()
    assert fused_gn_afno.launches_by_path["hopper_f32"] == before["hopper_f32"] + 1
    assert fused_gn_afno.launches_by_path["general"] == before["general"]
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 5e-5
    assert rel_l2(got, want) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("path,dtype,shape", [
    ("hopper", torch.bfloat16, {}),
    ("hopper_f32", torch.float32, {}),
    ("general", torch.float32, dict(H=8, W=8, C=96, nb=4, modes=3, groups=8)),
    ("general", torch.bfloat16, dict(H=8, W=8, C=96, nb=4, modes=3, groups=8)),
])
@pytest.mark.parametrize("act", ["silu", "tanh", "relu", "sigmoid", "leaky_relu",
                                 "softplus", "elu", "gelu"])
def test_non_gelu_activations_on_both_paths(cuda, path, dtype, shape, act):
    """The mode MLP applies the act it is given on every kernel: Ti bf16
    (Hopper), Ti f32 (f32 Hopper) and a ragged shape in f32 and bf16
    (general); every activation of the registry, gelu in its erf form.
    Tolerances as above."""
    args = ti_block_args(3, dtype, cuda, seed=31, **shape)
    before = fused_gn_afno.launches_by_path[path]
    got = fused_gn_afno(*args, approximate=False, act=act).float()
    want = fused_gn_afno_ref(*args, approximate=False, act=act).float()
    torch.cuda.synchronize()
    assert fused_gn_afno.launches_by_path[path] == before + 1
    lim = 5e-5 if dtype == torch.float32 else 4 * 2.0**-7 * want.abs().max().item()
    assert (got - want).abs().max().item() <= lim


# DPOT-H's block shapes: 8 AFNO blocks of 256 channels, GroupNorm(8)
H_BLOCK = dict(C=2048, nb=8)


def check_wide(args, act="gelu"):
    """One call on the kernel for blocks of 256 channels (afno_hopper_wide.cu)
    against the plain version: 4 bf16 ulps of the output's magnitude and
    4e-3 relative L2, as chip_smoke.py holds it."""
    before = dict(fused_gn_afno.launches_by_path)
    got = fused_gn_afno(*args, approximate=True, act=act).float()
    want = fused_gn_afno_ref(*args, approximate=True, act=act).float()
    torch.cuda.synchronize()
    assert fused_gn_afno.launches_by_path["hopper_wide"] == before["hopper_wide"] + 1
    assert fused_gn_afno.launches_by_path["general"] == before["general"]
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 4 * 2.0**-7 * want.abs().max().item()
    assert rel_l2(got, want) <= 4e-3


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 3, 20])
def test_hopper_wide_kernel_matches_plain_version(cuda, B):
    """bf16 at the DPOT-H block shapes takes the two-launch kernel for AFNO
    blocks of 256 channels."""
    check_wide(ti_block_args(B, torch.bfloat16, cuda, seed=80 + B, **H_BLOCK))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [
    dict(H_BLOCK, H=16, W=8, modes=8),       # 128 px, K 40: one short mode chunk
    dict(H_BLOCK, H=16, W=8, modes=16),      # 128 px, K 80: a partial second chunk
    dict(H_BLOCK, H=32, W=8, modes=32),      # K 160: 2K = 320, the most o rows
    dict(H_BLOCK, modes=2),                  # K 4: 2K = 8
    dict(H_BLOCK, groups=16),                # groups of 128 channels, two per block
    dict(H_BLOCK, groups=256),               # groups of 8
    dict(C=256, nb=1, groups=1),             # one AFNO block, one group
    dict(C=512, nb=2, groups=2),             # two blocks, a group each
])
def test_hopper_wide_kernel_at_admitted_edge_shapes(cuda, shape):
    """Each kind of shape that hopper_wide_supported admits besides H
    (tests/test_torch_afno_wide.py::ADMITTED_WIDE_EDGES lists the same
    kinds) runs on the wide kernel and matches the plain version."""
    check_wide(ti_block_args(2, torch.bfloat16, cuda, seed=42, **shape))


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["silu", "tanh", "relu", "sigmoid", "leaky_relu",
                                 "softplus", "elu", "gelu"])
def test_non_gelu_activations_on_the_wide_kernel(cuda, act):
    """The wide kernel's mode MLP applies the act it is given, at the DPOT-H
    block shapes; gelu in its tanh form (approximate, as bf16 runs it)."""
    check_wide(ti_block_args(3, torch.bfloat16, cuda, seed=32, **H_BLOCK), act)


# DPOT-L's block shapes: 16 AFNO blocks of 96 channels, GroupNorm(8)'s groups
# of 192 channels straddling two blocks each
L_BLOCK = dict(C=1536, nb=16, groups=8)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 8, 20])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_general_kernel_at_the_dpot_l_block_shapes(cuda, dtype, B, monkeypatch):
    """The five-launch kernel, forced on at L (which takes the kernels for
    96-channel blocks), computes its statistics per group whatever the
    blocks: against the plain version within the limits above (f32 5e-5
    absolute; bf16 4 bf16 ulps of the output's magnitude and 4e-3 relative
    L2)."""
    monkeypatch.setattr(afno_fused, "kernel_path", lambda *shapes: "general")
    args = ti_block_args(B, dtype, cuda, seed=90 + B, **L_BLOCK)
    approx = dtype == torch.bfloat16
    before = dict(fused_gn_afno.launches_by_path)
    got = fused_gn_afno(*args, approximate=approx).float()
    want = fused_gn_afno_ref(*args, approximate=approx).float()
    torch.cuda.synchronize()
    assert fused_gn_afno.launches_by_path["general"] == before["general"] + 1
    assert sum(fused_gn_afno.launches_by_path.values()) == sum(before.values()) + 1
    assert torch.isfinite(got).all()
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 5e-5
    else:
        assert (got - want).abs().max().item() <= 4 * 2.0**-7 * want.abs().max().item()
        assert rel_l2(got, want) <= 4e-3


# the kernels for AFNO blocks of 96 channels, by compute type
L_PATHS = {torch.bfloat16: "hopper_l", torch.float32: "hopper_f32_l"}


def check_l(args, dtype, act="gelu"):
    """One call on the kernel for 96-channel blocks of the compute type
    (afno_hopper_l.cu, afno_hopper_f32_l.cu) against the plain version, as
    chip_smoke.py holds them: f32 5e-5 absolute and 1e-5 relative L2 (3xTF32
    products, so summation order); bf16 4 bf16 ulps of the output's
    magnitude and 4e-3 relative L2 (a rounding of z, h or o that falls the
    other way)."""
    path, approx = L_PATHS[dtype], dtype == torch.bfloat16
    before = dict(fused_gn_afno.launches_by_path)
    got = fused_gn_afno(*args, approximate=approx, act=act).float()
    want = fused_gn_afno_ref(*args, approximate=approx, act=act).float()
    torch.cuda.synchronize()
    assert fused_gn_afno.launches_by_path[path] == before[path] + 1
    assert sum(fused_gn_afno.launches_by_path.values()) == sum(before.values()) + 1
    assert torch.isfinite(got).all()
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 5e-5
        assert rel_l2(got, want) <= 1e-5
    else:
        assert (got - want).abs().max().item() <= 4 * 2.0**-7 * want.abs().max().item()
        assert rel_l2(got, want) <= 4e-3


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 8, 16, 20])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_l_kernels_at_the_dpot_l_block_shapes(cuda, dtype, B):
    """L in each compute type takes its kernel for 96-channel blocks, whose
    CTAs compute the statistics of groups that span two blocks; B = 16 is
    the batch of configs/pretrain_large.yaml."""
    check_l(ti_block_args(B, dtype, cuda, seed=110 + B, **L_BLOCK), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,shape", [
    (torch.bfloat16, L_BLOCK), (torch.bfloat16, {}),
    (torch.float32, L_BLOCK), (torch.float32, {}),
])
def test_working_copy_vectors_and_weights_equal_the_f32_call(cuda, dtype, shape):
    """gscale, gbias, w1, b1, w2 and b2 from a bf16 working copy give the
    same output, bit for bit, as the f32 call on those values (hopper_l and
    hopper in bf16, hopper_f32_l and hopper_f32 in f32): the wrapper upcasts
    the vectors exactly, and the weights reach each kernel as the same
    values."""
    args = list(ti_block_args(4, dtype, cuda, seed=61, **shape))
    idx = (1, 2, 5, 6, 7, 8)
    lp = [a.to(torch.bfloat16) if i in idx else a for i, a in enumerate(args)]
    ref = [a.to(torch.bfloat16).float() if i in idx else a for i, a in enumerate(args)]
    x, *_, K, groups = args
    path = afno_fused.kernel_path(*x.shape, K, (shape or {"nb": 4})["nb"], groups, dtype)
    before = fused_gn_afno.launches_by_path[path]
    approx = dtype == torch.bfloat16
    got = fused_gn_afno(*lp, approximate=approx)
    want = fused_gn_afno(*ref, approximate=approx)
    torch.cuda.synchronize()
    assert path in ("hopper_l", "hopper", "hopper_f32_l", "hopper_f32")
    assert fused_gn_afno.launches_by_path[path] == before + 2
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_dpot_l_block_under_checkpoint_gives_the_same_gradients(cuda):
    """One bf16 trunk block at DPOT-L's width (1536, 16 AFNO blocks of 96,
    mlp_ratio 4) run under torch.utils.checkpoint, as remat runs it: its
    forward launches hopper_l twice (once more in the backward), and the
    gradients of the input and of every parameter equal the block's without
    checkpoint (the same kernels on the same inputs)."""
    from torch.utils.checkpoint import checkpoint

    from dpot_tpu_torch.models.dpot import Block

    blk = Block(1536, 16, 32, 4.0, "gelu", torch.bfloat16,
                torch.Generator().manual_seed(0)).to(cuda)
    gen = torch.Generator(cuda).manual_seed(3)
    x = torch.randn((4, 16, 16, 1536), generator=gen, device=cuda).to(torch.bfloat16)
    g = torch.randn(x.shape, generator=gen, device=cuda).to(torch.bfloat16)
    leaves = [x.requires_grad_(), *blk.parameters()]
    grads = {}
    for remat in (False, True):
        before = fused_gn_afno.launches_by_path["hopper_l"]
        out = (checkpoint(blk, x, use_reentrant=False, preserve_rng_state=False)
               if remat else blk(x))
        grads[remat] = torch.autograd.grad(out, leaves, g)
        torch.cuda.synchronize()
        assert fused_gn_afno.launches_by_path["hopper_l"] == before + 1 + remat
    for a, b in zip(grads[True], grads[False]):
        assert torch.isfinite(a).all() and torch.equal(a, b)


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,shape", [
    (BF16, dict(C=384, nb=4, groups=4)),               # a group per block
    (BF16, dict(C=384, nb=4, groups=2)),               # a group per block pair
    (BF16, dict(L_BLOCK, groups=16)),                  # L's width, a group per block
    (BF16, dict(L_BLOCK, H=16, W=8, modes=8)),         # 128 px, K 40: one short chunk
    (BF16, dict(L_BLOCK, H=32, W=8, modes=32)),        # K 160: 2K = 320, the most o rows
    (BF16, dict(L_BLOCK, modes=2)),                    # K 4: 2K = 8
    (F32, dict(C=192, nb=2, groups=1)),                # one block pair, C 192
    (F32, dict(C=384, nb=4, groups=4)),                # a group per block
    (F32, dict(L_BLOCK, groups=16)),                   # L's width, a group per block
    (F32, dict(L_BLOCK, H=16, W=8, modes=16)),         # 128 px, K 80: a partial chunk
    (F32, dict(L_BLOCK, H=8, W=8, modes=4)),           # 64 px, K 16: one pixel tile
    (F32, dict(C=384, nb=4, groups=2, H=32, W=32, modes=12)),  # 1024 px: 32 pixel chunks
    (F32, dict(L_BLOCK, modes=2)),                     # K 4: 2K = 8
])
def test_l_kernels_at_admitted_edge_shapes(cuda, dtype, shape):
    """Each kind of shape that hopper_l_supported and hopper_f32_l_supported
    admit besides L (tests/test_torch_afno_l.py lists the same kinds) runs
    on its kernel and matches the plain version."""
    args = ti_block_args(2, dtype, cuda, seed=44, **shape)
    x, *_, K, groups = args
    B, HW, C = x.shape
    assert afno_fused.kernel_path(B, HW, C, K, shape["nb"], groups, dtype) == L_PATHS[dtype]
    check_l(args, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("act", ["silu", "tanh", "relu", "sigmoid", "leaky_relu",
                                 "softplus", "elu", "gelu"])
def test_non_gelu_activations_on_the_l_kernels(cuda, dtype, act):
    """The mode MLP of both kernels for 96-channel blocks applies the act it
    is given, at the DPOT-L block shapes; gelu in its tanh form in bf16 and
    its erf form in f32, as the model runs them."""
    check_l(ti_block_args(3, dtype, cuda, seed=33, **L_BLOCK), dtype, act)


@pytest.mark.gpu
def test_evaluate_on_the_card_matches_the_cpu(cuda):
    """evaluate() of one small f32 DPOT on the card (the kernels) and on the
    CPU (their plain versions), same weights and test set: every number
    within 2e-4 relative, the repo's interop bar."""
    from dpot_tpu_torch.data.registry import make_synthetic_spec
    from dpot_tpu_torch.models import build_model
    from dpot_tpu_torch.train.evaluator import evaluate

    make_synthetic_spec("synthetic_gpu_eval", train_size=4, test_size=6, t_total=12,
                        t_test=4, in_size=(32, 32), n_channels=2)
    kw = dict(img_size=32, patch_size=4, in_channels=2, in_timesteps=6, embed_dim=256,
              depth=2, n_blocks=2, modes=4, n_cls=1, seed=3)
    got = evaluate(build_model("DPOT", device="cuda", **kw), ["synthetic_gpu_eval"],
                   res=32, t_in=6, batch_size=3, num_workers=1, full_metrics=True)
    want = evaluate(build_model("DPOT", device="cpu", **kw), ["synthetic_gpu_eval"],
                    res=32, t_in=6, batch_size=3, num_workers=1, full_metrics=True)
    for k, w in want["synthetic_gpu_eval"].items():
        assert abs(got["synthetic_gpu_eval"][k] - w) <= 2e-4 * abs(w), k


@pytest.mark.gpu
def test_fused_gn_afno_raises_on_mixed_devices(cuda):
    args = list(ti_block_args(1, torch.float32, cuda))
    args[1] = args[1].cpu()
    with pytest.raises(ValueError, match="cuda"):
        fused_gn_afno(*args)


def rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_gn_afno_gradient_matches_autograd_through_plain(cuda, dtype, monkeypatch):
    """The forward launches the kernel and carries a FusedGnAfno grad_fn; its
    backward (the VJP) never calls the plain version, which is made to raise.
    Against autograd through fused_gn_afno_ref: f32 1e-4 rel-L2 (summation
    order); bf16 2e-2 (the kernel's and the recompute's bf16 roundings of z,
    h and o may fall apart by one ulp)."""
    x, gs, gb, A, Ainv, w1, b1, w2, b2, K, groups = ti_block_args(4, dtype, cuda)
    leaves = [t.requires_grad_() for t in (x, gs, gb, w1, b1, w2, b2)]
    args = (x, gs, gb, A, Ainv, w1, b1, w2, b2, K, groups)
    approx = dtype == torch.bfloat16
    before = fused_gn_afno.launches
    out = fused_gn_afno(*args, approximate=approx)
    assert fused_gn_afno.launches == before + 1
    assert type(out.grad_fn).__name__ == "FusedGnAfnoBackward"
    g = torch.randn(out.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(1))
    g = g.to(dtype)

    def boom(*a, **k):
        raise AssertionError("the plain version ran in the backward")

    monkeypatch.setattr(afno_fused, "fused_gn_afno_ref", boom)
    got = torch.autograd.grad(out, leaves, g)
    monkeypatch.undo()
    want = torch.autograd.grad(fused_gn_afno_ref(*args, approximate=approx), leaves, g)
    torch.cuda.synchronize()
    lim = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b in zip(got, want):
        assert torch.isfinite(a).all() and rel_l2(a, b) <= lim


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gradient_at_the_dpot_l_block_shapes(cuda, dtype):
    """At L the forward that FusedGnAfno saves for its VJP runs on the kernel
    for 96-channel blocks: the gradient against autograd through the plain
    version, limits as above."""
    x, gs, gb, A, Ainv, w1, b1, w2, b2, K, groups = ti_block_args(4, dtype, cuda, seed=7,
                                                                   **L_BLOCK)
    leaves = [t.requires_grad_() for t in (x, gs, gb, w1, b1, w2, b2)]
    args = (x, gs, gb, A, Ainv, w1, b1, w2, b2, K, groups)
    approx = dtype == torch.bfloat16
    before = fused_gn_afno.launches_by_path[L_PATHS[dtype]]
    out = fused_gn_afno(*args, approximate=approx)
    assert fused_gn_afno.launches_by_path[L_PATHS[dtype]] == before + 1
    assert type(out.grad_fn).__name__ == "FusedGnAfnoBackward"
    g = torch.randn(out.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(2))
    got = torch.autograd.grad(out, leaves, g.to(dtype))
    want = torch.autograd.grad(fused_gn_afno_ref(*args, approximate=approx), leaves,
                               g.to(dtype))
    torch.cuda.synchronize()
    lim = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b in zip(got, want):
        assert torch.isfinite(a).all() and rel_l2(a, b) <= lim


ACTS = sorted(bias_act_op.activation_funcs)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 64, 64, 512), (3, 17, 5, 37)])
def test_bias_act_kernel_matches_plain_version(cuda, dtype, shape):
    """All nine activations with clamp, the vector path (C = 512) and the
    element path (C = 37). The kernel computes in f32 and rounds once; the
    plain version rounds after each op (the bias add, the activation, the
    gain: three half-ulp roundings, plus the kernel's one), so f32 differs
    by 1e-6 relative and bf16 by two bf16 ulps of the value (an ulp is at
    most 2^-7 |y|, so 2^-6 |y|) plus 2^-9, as chip_smoke.py holds it."""
    gen = torch.Generator(cuda).manual_seed(0)
    x = (2 * torch.randn(shape, device=cuda, generator=gen)).to(dtype)
    b = torch.randn(shape[-1], device=cuda, generator=gen).to(dtype)
    for act in ACTS:
        before = bias_act.launches
        got = bias_act(x, b, act, clamp=3.0)
        want = bias_act_op.bias_act_ref(x, b, -1, act, clamp=3.0)
        torch.cuda.synchronize()
        assert bias_act.launches == before + 1 and got.dtype == want.dtype
        err = (got.float() - want.float()).abs()
        if dtype == torch.float32:
            lim = 1e-6 * want.float().abs() + 1e-6
        else:
            lim = 2.0**-6 * want.float().abs() + 2.0**-9
        assert (err <= lim).all(), act


@pytest.mark.gpu
def test_bias_act_gradients_on_the_card(cuda):
    """First and second order through the Function on CUDA tensors, against
    autograd through the plain version (f32, 1e-5 rel-L2)."""
    gen = torch.Generator(cuda).manual_seed(2)
    x0 = torch.randn(6, 33, device=cuda, generator=gen)
    b0 = torch.randn(33, device=cuda, generator=gen)
    for act in ACTS:
        res = []
        for fn in (lambda x, b: bias_act(x, b, act),
                   lambda x, b: bias_act_op.bias_act_ref(x, b, -1, act)):
            x, b = x0.clone().requires_grad_(), b0.clone().requires_grad_()
            g1 = torch.autograd.grad(torch.sin(fn(x, b)).sum(), [x, b], create_graph=True)
            g2 = torch.autograd.grad((g1[0] ** 2).sum() + (g1[1] ** 2).sum(), [x, b])
            res.append((*g1, *g2))
        for a, w in zip(*res):
            assert rel_l2(a, w) <= 1e-5, act


# ------------------------------------------------ one dispatch: CUDA graphs
# graph against eager runs the same kernels on the same inputs: held to 1e-6
# relative (losses) and relative L2 (weights and predictions), as
# chip_smoke.py's dispatch phases hold them

GRAPH_TOL = 1e-6


def ti_state(cuda, seed=3, working_copy=False):
    from dpot_tpu_torch.models import build_model
    from dpot_tpu_torch.train.optimizers import build_optimizer
    from dpot_tpu_torch.train.state import TrainState

    model = build_model("DPOT", preset="Ti", img_size=128, patch_size=8, in_channels=4,
                        in_timesteps=10, n_cls=1, dtype=torch.bfloat16, device=cuda,
                        seed=seed)
    return TrainState.create(model, build_optimizer("adam", model.parameters(), 1e-3), 4,
                             param_working_dtype=torch.bfloat16 if working_copy else None)


def ti_batches(cuda, k, B=2, seed=7):
    gen = torch.Generator(cuda).manual_seed(seed)
    return {"x": torch.randn((k, B, 128, 128, 10, 4), generator=gen, device=cuda),
            "y": torch.randn((k, B, 128, 128, 1, 4), generator=gen, device=cuda),
            "cls": torch.zeros((k, B), dtype=torch.long, device=cuda)}


def weights_rel_l2(a, b):
    return max(rel_l2(p, q) if not torch.equal(p, q) else 0.0
               for p, q in zip(a.model.parameters(), b.model.parameters()))


@pytest.mark.gpu
def test_graphed_k_steps_equal_eager_steps(cuda):
    """DPOT-Ti bf16: two 2-step dispatches (the first runs eagerly and
    captures, the second replays the graph), noise from the state's
    generator, against four eager steps: the losses, the final weights,
    the step and the hopper launches (4 a step, replays counted)."""
    from dpot_tpu_torch.train.step import make_train_step

    a, b = ti_state(cuda), ti_state(cuda)
    batches = [ti_batches(cuda, 2, seed=s) for s in (1, 2)]
    fn = make_train_step(scan_steps=2, noise_scale=5e-4, ones_mask=True)
    step = make_train_step(noise_scale=5e-4, ones_mask=True)
    before = fused_gn_afno.launches_by_path["hopper"]
    got = torch.cat([fn(a, bt)[1]["loss_step"] for bt in batches]).tolist()
    torch.cuda.synchronize()
    assert fused_gn_afno.launches_by_path["hopper"] == before + 4 * 4
    want = [step(b, {k: v[i] for k, v in bt.items()})[1]["loss_step"].item()
            for bt in batches for i in range(2)]
    assert a.step == b.step == 4 and a.optimizer.count == 4
    assert max(abs(x - y) / abs(y) for x, y in zip(got, want)) <= GRAPH_TOL
    assert weights_rel_l2(a, b) <= GRAPH_TOL


@pytest.mark.gpu
def test_graphed_dispatch_with_working_copy_and_grad_accum(cuda):
    """The bf16 working copy and grad_accum=2 (f32 microbatch sums) inside
    the graph: two 2-step dispatches against four eager steps, the f32
    masters compared, and the copy still the masters' exact cast."""
    from dpot_tpu_torch.train.step import make_train_step

    a, b = ti_state(cuda, working_copy=True), ti_state(cuda, working_copy=True)
    batches = [ti_batches(cuda, 2, B=4, seed=s) for s in (3, 4)]
    kw = dict(noise_scale=5e-4, ones_mask=True, grad_accum=2)
    fn, step = make_train_step(scan_steps=2, **kw), make_train_step(**kw)
    got = torch.cat([fn(a, bt)[1]["loss_step"] for bt in batches]).tolist()
    want = [step(b, {k: v[i] for k, v in bt.items()})[1]["loss_step"].item()
            for bt in batches for i in range(2)]
    assert max(abs(x - y) / abs(y) for x, y in zip(got, want)) <= GRAPH_TOL
    for p, q in zip(a.optimizer.params, b.optimizer.params):
        assert torch.equal(p, q) or rel_l2(p, q) <= GRAPH_TOL
    assert all(torch.equal(p, m.to(torch.bfloat16))
               for p, m in zip(a.params_lp, a.optimizer.params))


@pytest.mark.gpu
def test_graphed_eval_rollout_equals_eager_and_reads_live_weights(cuda):
    """The eval rollout's graph (DPOT-Ti bf16, B 2, t_test 3), captured at
    its first call and replayed after an eager train step has moved the
    weights, against the eager rollout on those weights; the launches of
    the replay counted."""
    from dpot_tpu_torch.train.step import make_eval_rollout, make_train_step

    state = ti_state(cuda)
    gen = torch.Generator(cuda).manual_seed(9)
    batch = {"x": torch.randn((2, 128, 128, 10, 4), generator=gen, device=cuda),
             "y": torch.randn((2, 128, 128, 3, 4), generator=gen, device=cuda),
             "msk": torch.ones((2, 128, 128, 1, 4), device=cuda)}
    roll = make_eval_rollout()
    first = roll(state.model, batch)
    torch.testing.assert_close(first["pred"], roll.run(state.model, batch)["pred"],
                               rtol=0, atol=0)
    step = make_train_step(ones_mask=True)
    step(state, {k: v[0] for k, v in ti_batches(cuda, 1).items()})
    before = fused_gn_afno.launches_by_path["hopper"]
    got = roll(state.model, batch)
    torch.cuda.synchronize()
    assert fused_gn_afno.launches_by_path["hopper"] == before + 4 * 3
    want = roll.run(state.model, batch)
    assert rel_l2(got["pred"], want["pred"]) <= GRAPH_TOL
    assert rel_l2(got["pred"], first["pred"]) > GRAPH_TOL  # the weights moved
    for k in ("loss_step", "loss_full"):
        assert abs(got[k].item() - want[k].item()) <= GRAPH_TOL * abs(want[k].item())


@pytest.mark.gpu
def test_graphed_served_answer_equals_eager(cuda):
    """RolloutServer on the card (DPOT-Ti bf16): start() captures every
    bucket at the warm-up step count and counts each as a compile; a new
    step count captures at first use; every answer (B 1 and 3, steps 1 and
    2) equals the eager server's."""
    from dpot_tpu_torch.serve import RolloutServer

    state = ti_state(cuda, seed=5)
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal((b, 128, 128, 10, 4)).astype(np.float32) for b in (1, 3)]
    answers = {}
    for graphed in (True, False):
        rs = RolloutServer(state.model, batch_buckets=(1, 4), max_wait_ms=0.0,
                           warmup_steps=(1,), device=cuda)
        rs._graphed = graphed
        rs.start()
        try:
            answers[graphed] = [rs.submit(x, s) for x in xs for s in (1, 2, 2)]
            compiles = rs.metrics()["compiles"]
        finally:
            rs.stop(drain=True)
        assert compiles == (4 if graphed else 2)
    for got, want in zip(answers[True], answers[False]):
        assert rel_l2(torch.from_numpy(got), torch.from_numpy(want)) <= GRAPH_TOL


@pytest.mark.gpu
def test_graphed_step_replays_read_live_weights_not_cached_copies(cuda):
    """The stale-weight case: a 1-step dispatch captured, then replayed 3
    times, against 4 eager steps: a graph that read the bf16 copy of the
    AFNO weights cached before its capture would replay the old weights."""
    from dpot_tpu_torch.train.step import KStepDispatch, make_train_step

    a, b = ti_state(cuda), ti_state(cuda)
    step = make_train_step(noise_scale=5e-4, ones_mask=True)
    dispatch = KStepDispatch(step, 1)
    batches = [ti_batches(cuda, 1, seed=20 + i) for i in range(4)]
    got = [dispatch(a, bt)[1]["loss_step"][0].item() for bt in batches]
    want = [step(b, {k: v[0] for k, v in bt.items()})[1]["loss_step"].item() for bt in batches]
    assert max(abs(x - y) / abs(y) for x, y in zip(got, want)) <= GRAPH_TOL
    assert weights_rel_l2(a, b) <= GRAPH_TOL


@pytest.mark.gpu
def test_device_constant_miss_under_a_real_capture_raises(cuda):
    """A DFT operator shape never made before, asked for during a capture,
    raises naming the shape; the capture ends with the error."""
    from dpot_tpu_torch.ops.cuda.graphs import Graph

    with pytest.raises(RuntimeError, match="12x12"):
        Graph(lambda: combined_spectral_ops(12, 12, 3, 3, torch.float32, cuda))


# the torch.fft routes (PR 10): DPOT3D's mixer and the 2D separable route
# inside graphs; small widths, the shapes' kinds of the card's main paths
SMALL_3D = dict(img_size=32, patch_size=8, in_channels=5, out_channels=5, in_timesteps=4,
                embed_dim=192, depth=2, n_blocks=2, modes=32, n_cls=1)
SMALL_SEP = dict(img_size=136, patch_size=2, in_channels=4, out_channels=4, in_timesteps=4,
                 embed_dim=64, depth=2, n_blocks=2, modes=16, n_cls=1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_graphed_3d_eval_rollout_equals_eager_and_makes_no_fft_plan(cuda, dtype):
    """DPOT3D's eval rollout graph against the eager rollout; the eager run
    makes the cuFFT plans, and neither the capture nor a replay adds one."""
    from dpot_tpu_torch.models import build_model
    from dpot_tpu_torch.train.step import make_eval_rollout

    model = build_model("DPOT3D", dtype=dtype, device=cuda, seed=1, **SMALL_3D)
    gen = torch.Generator(cuda).manual_seed(2)
    batch = {"x": torch.randn((2, 32, 32, 32, 4, 5), generator=gen, device=cuda),
             "y": torch.randn((2, 32, 32, 32, 3, 5), generator=gen, device=cuda),
             "msk": torch.ones((2, 32, 32, 32, 1, 5), device=cuda)}
    roll = make_eval_rollout()
    want = roll.run(model, batch)
    plans = torch.backends.cuda.cufft_plan_cache[torch.cuda.current_device()]
    n = plans.size
    roll(model, batch)
    got = roll(model, batch)
    torch.cuda.synchronize()
    assert plans.size == n and roll.graphs.captures == 1
    assert rel_l2(got["pred"], want["pred"]) <= GRAPH_TOL
    for k in ("loss_step", "loss_full"):
        assert abs(got[k].item() - want[k].item()) <= GRAPH_TOL * abs(want[k].item())


@pytest.mark.gpu
def test_graphed_3d_train_dispatch_equals_eager_steps(cuda):
    """A 2-step dispatch of a pred-only DPOT3D (the FFTs' backward inside the
    capture) against two eager steps: losses and weights."""
    from dpot_tpu_torch.models import build_model
    from dpot_tpu_torch.train.optimizers import build_optimizer
    from dpot_tpu_torch.train.state import TrainState
    from dpot_tpu_torch.train.step import make_train_step

    states = []
    for _ in range(2):
        m = build_model("DPOT3D", dtype=torch.bfloat16, device=cuda, seed=3, **SMALL_3D)
        states.append(TrainState.create(m, build_optimizer("adam", m.parameters(), 1e-4), 5))
    gen = torch.Generator(cuda).manual_seed(4)
    bt = {"x": torch.randn((2, 2, 32, 32, 32, 4, 5), generator=gen, device=cuda),
          "y": torch.randn((2, 2, 32, 32, 32, 1, 5), generator=gen, device=cuda),
          "cls": torch.zeros((2, 2), dtype=torch.long, device=cuda)}
    kw = dict(noise_scale=5e-4, ones_mask=True)
    dispatch, step = make_train_step(scan_steps=2, **kw), make_train_step(**kw)
    dispatch(states[0], bt)                     # eager, then the capture
    got = dispatch(states[0], bt)[1]["loss_step"].tolist()
    want = [step(states[1], {k: v[i] for k, v in bt.items()})[1]["loss_step"].item()
            for _ in range(2) for i in range(2)][2:]
    assert max(abs(x - y) / abs(y) for x, y in zip(got, want)) <= GRAPH_TOL
    assert weights_rel_l2(*states) <= GRAPH_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_separable_route_graphed_rollout_counts_its_calls(cuda, dtype):
    """A 2D model at a 4624-px latent: the eval rollout's graph against the
    eager rollout, the separable route counted depth x steps at every
    replay, fused_gn_afno never launched."""
    from dpot_tpu_torch.models import build_model
    from dpot_tpu_torch.ops.spectral import separable_gn_afno
    from dpot_tpu_torch.train.step import make_eval_rollout

    model = build_model("DPOT", dtype=dtype, device=cuda, seed=6, **SMALL_SEP)
    gen = torch.Generator(cuda).manual_seed(7)
    batch = {"x": torch.randn((2, 136, 136, 4, 4), generator=gen, device=cuda),
             "y": torch.randn((2, 136, 136, 3, 4), generator=gen, device=cuda),
             "msk": torch.ones((2, 136, 136, 1, 4), device=cuda)}
    roll = make_eval_rollout()
    want = roll.run(model, batch)
    launches, calls = fused_gn_afno.launches, separable_gn_afno.calls
    roll(model, batch)
    assert separable_gn_afno.calls == calls + 2 * 3  # the eager first call only
    got = roll(model, batch)
    torch.cuda.synchronize()
    assert separable_gn_afno.calls == calls + 2 * 2 * 3
    assert fused_gn_afno.launches == launches
    assert rel_l2(got["pred"], want["pred"]) <= GRAPH_TOL


def host_float_update(rule, params, mu, nu, grads, b1, lr, b2, eps, wd, clip, count):
    """One update of the three optimizers with the per-step scalars as host
    floats (the fused alpha forms of `_foreach_add_`): the reference that
    train/optimizers.py's device-scalar rows must match bit for bit."""
    grads = [g.float() for g in grads]
    gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    if clip is not None:
        grads = torch._foreach_mul(grads, torch.clamp(clip / (gnorm + 1e-6), max=1.0))
    if rule == "adam" and wd:
        grads = torch._foreach_add(grads, params, alpha=wd)
    mu32 = [m if m.dtype == torch.float32 else m.float() for m in mu]
    torch._foreach_mul_(mu32, b1)
    torch._foreach_add_(mu32, grads, alpha=1.0 - b1)
    for m, a in zip(mu, mu32):
        if m is not a:
            m.copy_(a)
    torch._foreach_mul_(nu, b2)
    torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
    mu_p = [m.to(p.dtype) for m, p in zip(mu, params)]
    denom = torch._foreach_sqrt(nu)
    if rule == "lamb":
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_div(mu_p, denom)
        torch._foreach_add_(upd, params, alpha=wd)
        torch._foreach_add_(params, upd, alpha=-lr)
        return
    torch._foreach_div_(denom, (1.0 - b2 ** count) ** 0.5)
    torch._foreach_add_(denom, eps)
    upd = torch._foreach_div(mu_p, denom)
    torch._foreach_mul_(upd, -lr / (1.0 - b1 ** count))
    if rule == "adamw":
        torch._foreach_add_(upd, params, alpha=-lr * wd)
    torch._foreach_add_(params, upd)


@pytest.mark.gpu
@pytest.mark.parametrize("rule", ["adam", "adamw", "lamb"])
@pytest.mark.parametrize("moment", [torch.float32, torch.bfloat16])
def test_device_scalar_optimizer_equals_host_float_update(cuda, rule, moment):
    """Six scheduled updates (OneCycle lr, cycled b1, an active clip) with
    the per-step scalars as device rows, as a captured step reads them,
    against the same updates with host floats: weights and both moments
    bit for bit, so that the eager step computes what it did before its
    scalars moved to the device."""
    from dpot_tpu_torch.train.optimizers import build_optimizer
    from dpot_tpu_torch.train.schedules import onecycle, onecycle_momentum

    gen = torch.Generator(cuda).manual_seed(1)
    shapes = [(1536, 6144), (6144,), (2, 16, 96, 96), (7, 13, 5)]
    p0 = [torch.randn(s, device=cuda, generator=gen) * 0.02 for s in shapes]
    grads = [[torch.randn(s, device=cuda, generator=gen) for s in shapes] for _ in range(6)]
    lr, b1 = onecycle(1e-3, 6, 1, 3), onecycle_momentum(6, 1, 3)
    ps = [p.clone() for p in p0]
    opt = build_optimizer(rule, ps, lr, b1, beta2=0.99, grad_clip=1.0, moment_dtype=moment)
    ref = [p.clone() for p in p0]
    mu = [torch.zeros_like(p, dtype=moment) for p in p0]
    nu = [torch.zeros_like(p) for p in p0]
    for i, g in enumerate(grads):
        opt.step(g)
        host_float_update(rule, ref, mu, nu, g, b1(i), lr(i), 0.99, opt.eps,
                          opt.weight_decay, 1.0, i + 1)
    for a, b in zip(ps + opt.mu + opt.nu, ref + mu + nu):
        assert torch.equal(a, b)


CDPOT_TI = dict(img_size=128, patch_size=8, in_channels=4, in_timesteps=10, embed_dim=512,
                depth=4, n_blocks=4, modes=32, n_cls=12)


def cdpot_ti(cuda, dtype, seed=12):
    """CDPOT at configs/cdpot_parallel.yaml's widths, its AFNO weights drawn
    from N(0, 0.05^2) so that the mixer matters."""
    from dpot_tpu_torch.models import build_model

    model = build_model("CDPOT", dtype=dtype, device=cuda, seed=seed, **CDPOT_TI)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for blk in model.blocks:
            for w in (blk.filter.w1, blk.filter.b1, blk.filter.w2, blk.filter.b2):
                w.copy_(0.05 * torch.randn(w.shape, generator=gen))
    return model


@pytest.mark.gpu
def test_cdpot_served_in_bf16_on_hopper_matches_the_plain_mixer(cuda, monkeypatch):
    """CDPOT served in bf16 (graphed): every launch on the Hopper kernel,
    depth x applications; the answer within 3e-2 relative L2 of the same
    rollout with fused_gn_afno's plain version."""
    from dpot_tpu_torch.models import dpot
    from dpot_tpu_torch.serve import RolloutServer

    model = cdpot_ti(cuda, torch.bfloat16)
    x = np.random.default_rng(4).standard_normal((2, 128, 128, 10, 4)).astype(np.float32)
    before = dict(fused_gn_afno.launches_by_path)
    rs = RolloutServer(model, batch_buckets=(1, 2), max_wait_ms=0.0, warmup_steps=(1,),
                       device=cuda)
    rs.start()
    try:
        got = torch.from_numpy(rs.submit(x, 2))
    finally:
        rs.stop(drain=True)
    torch.cuda.synchronize()
    added = {p: n - before[p] for p, n in fused_gn_afno.launches_by_path.items()}
    assert added["hopper"] == sum(added.values()) == 4 * (2 + 2)
    monkeypatch.setattr(dpot, "fused_gn_afno", fused_gn_afno_ref)
    carry, want = torch.from_numpy(x).to(cuda, torch.bfloat16), []
    with torch.inference_mode():
        for _ in range(2):
            im = model(carry)[0]
            want.append(im)
            carry = torch.cat([carry[..., 1:, :], im.to(carry.dtype)], dim=-2)
    assert rel_l2(got, torch.cat(want, dim=-2).cpu()) <= 3e-2


@pytest.mark.gpu
def test_cdpot_graphed_f32_rollout_counts_hopper_f32_launches(cuda):
    """CDPOT in f32: the eval rollout's graph against the eager rollout,
    depth x steps launches on afno_hopper_f32.cu at the replay."""
    from dpot_tpu_torch.train.step import make_eval_rollout

    model = cdpot_ti(cuda, torch.float32)
    gen = torch.Generator(cuda).manual_seed(5)
    batch = {"x": torch.randn((2, 128, 128, 10, 4), generator=gen, device=cuda),
             "y": torch.randn((2, 128, 128, 3, 4), generator=gen, device=cuda),
             "msk": torch.ones((2, 128, 128, 1, 4), device=cuda)}
    roll = make_eval_rollout()
    want = roll.run(model, batch)
    roll(model, batch)
    before = dict(fused_gn_afno.launches_by_path)
    got = roll(model, batch)
    torch.cuda.synchronize()
    added = {p: n - before[p] for p, n in fused_gn_afno.launches_by_path.items()}
    assert added["hopper_f32"] == sum(added.values()) == 4 * 3
    assert rel_l2(got["pred"], want["pred"]) <= GRAPH_TOL


def unet_state(cuda, seed=8):
    from dpot_tpu_torch.models import build_model
    from dpot_tpu_torch.train.optimizers import build_optimizer
    from dpot_tpu_torch.train.state import TrainState

    m = build_model("UNet", img_size=64, in_channels=4, in_timesteps=10, out_layer_dim=8,
                    device=cuda, seed=seed)
    return TrainState.create(m, build_optimizer("adam", m.parameters(), 1e-4), 5)


@pytest.mark.gpu
def test_unet_graphed_dispatch_tracks_the_statistics_of_eager_steps(cuda, monkeypatch):
    """Two 2-step dispatches of UNet (train mode, its BatchNorm buffers
    updated in place at every replay) against four eager steps: losses,
    weights and running statistics; then its eval rollout's graph (eval
    mode, the running statistics) against the eager one. cuDNN's default
    convolution backward is not deterministic, so both use its
    deterministic algorithms."""
    from dpot_tpu_torch.train.step import make_eval_rollout, make_train_step

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)

    a, b = unet_state(cuda), unet_state(cuda)
    gen = torch.Generator(cuda).manual_seed(6)
    bts = [{"x": torch.randn((2, 2, 64, 64, 10, 4), generator=gen, device=cuda),
            "y": torch.randn((2, 2, 64, 64, 1, 4), generator=gen, device=cuda),
            "cls": torch.zeros((2, 2), dtype=torch.long, device=cuda)} for _ in range(2)]
    kw = dict(noise_scale=5e-4, ones_mask=True)
    dispatch, step = make_train_step(scan_steps=2, **kw), make_train_step(**kw)
    got = [v for bt in bts for v in dispatch(a, bt)[1]["loss_step"].tolist()]
    want = [step(b, {k: v[i] for k, v in bt.items()})[1]["loss_step"].item()
            for bt in bts for i in range(2)]
    assert max(abs(x - y) / abs(y) for x, y in zip(got, want)) <= GRAPH_TOL
    assert weights_rel_l2(a, b) <= GRAPH_TOL
    for (name, p), q in zip(a.model.named_buffers(), b.model.buffers()):
        assert (torch.equal(p, q) if "num_batches" in name else rel_l2(p, q) <= GRAPH_TOL), name
    batch = {"x": bts[0]["x"][0], "y": bts[0]["y"][0].expand(-1, -1, -1, 3, -1).contiguous(),
             "msk": torch.ones((2, 64, 64, 1, 4), device=cuda)}
    roll = make_eval_rollout()
    eager = roll.run(a.model, batch)
    roll(a.model, batch)
    replay = roll(a.model, batch)
    torch.cuda.synchronize()
    assert rel_l2(replay["pred"], eager["pred"]) <= GRAPH_TOL
    assert all(torch.equal(p, q) for p, q in zip(a.model.buffers(), b.model.buffers())
               if p.dtype == torch.long)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [(128, 128), (32, 32, 32), (64, 64)])
def test_irfftn_pair_of_a_non_hermitian_spectrum_matches_the_cpu(cuda, s):
    """cuFFT's real inverse of a spectrum that is not Hermitian differs
    from the CPU's (an FNO2d spectral convolution came out 12 % off);
    irfftn_pair drops the imaginary parts that make it so, on either
    device, so the two agree to f32 rounding."""
    from dpot_tpu_torch.ops.spectral import irfftn_pair

    g = torch.Generator().manual_seed(len(s))
    shape = (2, *s[:-1], s[-1] // 2 + 1, 8)
    re, im = torch.randn(shape, generator=g), torch.randn(shape, generator=g)
    dims = tuple(range(1, len(s) + 1))
    want = irfftn_pair(re, im, s, dims, norm="backward")
    got = irfftn_pair(re.to(cuda), im.to(cuda), s, dims, norm="backward")
    assert rel_l2(got.cpu(), want) <= 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("grid,modes", [((128, 128), (16, 16)), ((32, 32, 32), (8, 8, 8))])
def test_fno_spectral_conv_on_the_card_matches_the_cpu(cuda, grid, modes):
    """One spectral convolution on its own (in a model its init-scale
    weights hide it): the card against the CPU, f32, 1e-5."""
    from dpot_tpu_torch.models.fno import SpectralConv

    spec = SpectralConv(32, modes, torch.Generator().manual_seed(1))
    x = torch.randn(2, *grid, 32, generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        want = spec(x)
        got = spec.to(cuda)(x.to(cuda)).cpu()
    assert rel_l2(got, want) <= 1e-5
