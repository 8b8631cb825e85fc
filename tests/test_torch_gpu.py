"""Tests of the port that need the card: each hand-written CUDA kernel
against its plain PyTorch version, on CUDA tensors. They skip without a CUDA
device. The module imports neither JAX nor the JAX package, so on a machine
with the card it runs alone:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from dpot_tpu_torch.ops.cuda.afno_fused import fused_gn_afno, fused_gn_afno_ref
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
def test_fused_gn_afno_raises_on_mixed_devices(cuda):
    args = list(ti_block_args(1, torch.float32, cuda))
    args[1] = args[1].cpu()
    with pytest.raises(ValueError, match="cuda"):
        fused_gn_afno(*args)
