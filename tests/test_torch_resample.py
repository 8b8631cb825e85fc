"""The port's CNO resampling ops (dpot_tpu_torch/ops/resample.py) and FNO's
FFT pairs (ops/spectral.py, norm "backward") against the JAX package's
(dpot_tpu/ops/resample.py, the `xla` branches of dpot_tpu/ops/fourier.py),
on numpy-seeded inputs; f32 at 2e-4 absolute (PARITY.md), bf16 at 2e-2
relative L2."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpot_tpu.ops import fourier as jf
from dpot_tpu.ops import resample as jr
from dpot_tpu_torch.ops import resample as tr
from dpot_tpu_torch.ops import spectral as ts

ATOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


# the ratios CDPOT reaches (latent x2 and back, latent -> image at patches
# 4, 8 and 16) and a few odd ones, where JAX's test warns that the two
# conventions may differ at the borders
@pytest.mark.parametrize("size_in,size_out", [(16, 32), (32, 16), (8, 16), (16, 128),
                                              (4, 64), (8, 128), (7, 12), (12, 5), (9, 31)])
def test_resize_bilinear_matches_jax_image_resize(size_in, size_out):
    x = rand((2, size_in, size_in, 3), seed=size_in * 100 + size_out)
    want = jr.resize_bilinear(jnp.asarray(x), (size_out, size_out))
    got = tr.resize_bilinear(torch.from_numpy(x), (size_out, size_out))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


# the same ratios, and CDPOT's at 128^2 (x2 and back, to its 16^2 latent)
@pytest.mark.parametrize("size_in,size_out", [(16, 32), (32, 16), (8, 16), (16, 128),
                                              (7, 12), (12, 5), (128, 256), (256, 128),
                                              (128, 16)])
def test_resize_bilinear_gradient_is_the_adjoint_of_interpolate(size_in, size_out):
    """The gradient (two matrix products with F.interpolate's own per-axis
    weights) against torch's backward of F.interpolate, within 1e-6
    relative; the forward is F.interpolate's, bit for bit; bf16 inputs get
    it cast back."""
    import torch.nn.functional as F

    x = torch.from_numpy(rand((2, size_in, size_in, 3), seed=size_in + size_out))
    g = torch.from_numpy(rand((2, size_out, size_out, 3), seed=7))
    a = x.clone().requires_grad_()
    y = tr.resize_bilinear(a, (size_out, size_out))
    (y * g).sum().backward()
    b = x.clone().requires_grad_()
    want = F.interpolate(b.permute(0, 3, 1, 2), size=(size_out, size_out), mode="bilinear",
                         antialias=True, align_corners=False).permute(0, 2, 3, 1)
    (want * g).sum().backward()
    assert torch.equal(y, want)
    assert rel_l2(a.grad.numpy(), b.grad.numpy()) <= 1e-6
    c = x.to(torch.bfloat16).requires_grad_()
    tr.resize_bilinear(c, (size_out, size_out)).float().mul(g).sum().backward()
    assert c.grad.dtype == torch.bfloat16
    assert rel_l2(c.grad.float().numpy(), b.grad.numpy()) <= 1e-2


@pytest.mark.parametrize("out_size", [None, 32])
def test_lrelu_filtered_matches_jax(out_size):
    x, b = rand((2, 8, 8, 5), seed=1), rand((5,), seed=2)
    want = jr.lrelu_filtered(jnp.asarray(x), jnp.asarray(b), in_size=8, out_size=out_size)
    got = tr.lrelu_filtered(torch.from_numpy(x), torch.from_numpy(b), 8, out_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_lrelu_filtered_bf16_matches_jax_bf16():
    """bf16 in both: JAX resizes in bf16, the port in f32 rounded once per
    resize (torch's CPU kernel takes no bf16), so they differ by roundings."""
    x, b = rand((2, 16, 16, 4), seed=3), rand((4,), seed=4)
    want = jr.lrelu_filtered(jnp.asarray(x, jnp.bfloat16), jnp.asarray(b), in_size=16,
                             out_size=64)
    got = tr.lrelu_filtered(torch.from_numpy(x).bfloat16(), torch.from_numpy(b), 16, 64)
    assert got.dtype == torch.float32  # the f32 bias promotes, as in JAX
    assert rel_l2(got.numpy(), np.asarray(want, np.float32)) <= 2e-2


@pytest.mark.parametrize("in_rate,out_rate,out_size", [(2, 1, 4), (4, 1, 3), (3, 1, 5)])
def test_lrelu_regular_matches_jax(in_rate, out_rate, out_size):
    """The /2 and /4 average pools and the nearest fallback."""
    x = rand((2, 8, 8, 3), seed=in_rate)
    want = jr.lrelu_regular(jnp.asarray(x), in_rate, out_rate, out_size)
    got = tr.lrelu_regular(torch.from_numpy(x), in_rate, out_rate, out_size)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("K", [1, 2, 3])
def test_low_pass_filter_matches_jax(K):
    """K = 1 is the identity (the CDPOT head's call); above it, only the
    non-negative corner [:H//K, :H//K] of the full spectrum is kept."""
    x = rand((2, 12, 12, 3), seed=K)
    want = jr.low_pass_filter(jnp.asarray(x), K)
    got = tr.low_pass_filter(torch.from_numpy(x), K)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    if K == 1:
        assert torch.equal(got, torch.from_numpy(x))


@pytest.mark.parametrize("shape", [(2, 8, 6, 3), (2, 5, 7, 2)])
def test_rfft2_pair_backward_norm_matches_jax(shape):
    x = rand(shape, seed=7)
    jre, jim = jf.rfft2_pair(jnp.asarray(x), axes=(1, 2), norm="backward", backend="xla")
    re, im = ts.rfftn_pair(torch.from_numpy(x), (1, 2), norm="backward")
    np.testing.assert_allclose(re.numpy(), np.asarray(jre), atol=ATOL, rtol=0)
    np.testing.assert_allclose(im.numpy(), np.asarray(jim), atol=ATOL, rtol=0)
    want = jf.irfft2_pair(jre, jim, s=shape[1:3], axes=(1, 2), norm="backward",
                          backend="xla")
    got = ts.irfftn_pair(re, im, shape[1:3], (1, 2), norm="backward")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), x, atol=1e-5, rtol=0)


def test_rfft3_pair_backward_norm_matches_jax():
    x = rand((2, 6, 5, 8, 3), seed=8)
    jre, jim = jf.rfft3_pair(jnp.asarray(x), axes=(1, 2, 3), norm="backward", backend="xla")
    re, im = ts.rfftn_pair(torch.from_numpy(x), (1, 2, 3), norm="backward")
    np.testing.assert_allclose(re.numpy(), np.asarray(jre), atol=ATOL, rtol=0)
    np.testing.assert_allclose(im.numpy(), np.asarray(jim), atol=ATOL, rtol=0)
    want = jf.irfft3_pair(jre, jim, s=(6, 5, 8), axes=(1, 2, 3), norm="backward",
                          backend="xla")
    got = ts.irfftn_pair(re, im, (6, 5, 8), (1, 2, 3), norm="backward")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_fft2_pair_matches_jax():
    x = rand((2, 6, 7, 3), seed=9)
    jre, jim = jf.fft2_pair(jnp.asarray(x), axes=(1, 2), backend="xla")
    re, im = ts.fft2_pair(torch.from_numpy(x), dims=(1, 2))
    np.testing.assert_allclose(re.numpy(), np.asarray(jre), atol=ATOL, rtol=0)
    np.testing.assert_allclose(im.numpy(), np.asarray(jim), atol=ATOL, rtol=0)
    yr, yi = jf.ifft2_pair(jre, jim, axes=(1, 2), backend="xla")
    gr, gi = ts.ifft2_pair(re, im, dims=(1, 2))
    np.testing.assert_allclose(gr.numpy(), np.asarray(yr), atol=ATOL, rtol=0)
    np.testing.assert_allclose(gi.numpy(), np.asarray(yi), atol=ATOL, rtol=0)


@pytest.mark.parametrize("s", [(16, 16), (15, 15), (8, 6, 8)])
def test_irfftn_pair_drops_the_imaginary_parts_a_real_inverse_cannot_hold(s):
    """On a spectrum that is not Hermitian (as a mode MLP's output is not),
    the result ignores the imaginary parts of the last axis's DC and, for
    an even size, Nyquist bins, as torch's CPU irfftn and JAX's DFT do; the
    card's cuFFT would not, so the port drops them itself."""
    g = torch.Generator().manual_seed(len(s))
    shape = (2, *s[:-1], s[-1] // 2 + 1, 3)
    re, im = torch.randn(shape, generator=g), torch.randn(shape, generator=g)
    dims = tuple(range(1, len(s) + 1))
    got = ts.irfftn_pair(re, im, s, dims, norm="backward")
    want = torch.fft.irfftn(torch.complex(re, im), s=s, dim=dims, norm="backward")
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
    # i x (a constant over the leading axes) in those bins: after the
    # leading inverse, a purely imaginary DC (and Nyquist) line
    im2 = im.clone()
    im2.select(len(s), 0).add_(1.0)
    if s[-1] % 2 == 0:
        im2.select(len(s), s[-1] // 2).add_(1.0)
    moved = ts.irfftn_pair(re, im2, s, dims, norm="backward")
    assert rel_l2(moved.numpy(), got.numpy()) <= 1e-6
