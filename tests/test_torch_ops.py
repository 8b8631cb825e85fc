"""The port's plain ops (dpot_tpu_torch/ops) against the JAX package's:
activations, norms, initializers and the combined-operator spectral mixer.
Inputs come from numpy seeds; each tolerance says why it is what it is."""

import math

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from dpot_tpu_torch.ops import activations, initializers, norms, spectral


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test files at once, some of them timing host
    throughput; torch's CPU ops here keep to two threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def rand(shape, seed=0, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(shape) + shift).astype(np.float32)


@pytest.mark.parametrize("name", ["gelu", "tanh", "sigmoid", "relu", "leaky_relu",
                                  "softplus", "elu", "silu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_activations_follow_the_dtype_as_jax_does(name, dtype):
    """gelu is erf under f32 and tanh under bf16 in both packages. f32:
    1e-6 (the same formula, another libm). bf16: JAX evaluates the formula
    in bf16 arithmetic while torch rounds once from f32, so the two differ
    by bf16 roundings of terms as large as x or the result:
    |diff| <= 2^-7 (|x| + |result|) + 1e-6."""
    from dpot_tpu.ops.activations import get_activation as jax_act

    x = rand((4096,), scale=3.0)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = activations.get_activation(name)(xt).float().numpy()
    want = np.asarray(jax_act(name)(jnp.asarray(x, getattr(jnp, dtype))), np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    else:
        xb = xt.float().numpy()
        assert (np.abs(got - want) <= 2.0**-7 * (np.abs(xb) + np.abs(want)) + 1e-6).all()
    with pytest.raises(ValueError):
        activations.get_activation("nope")


def test_gelu_variant_per_dtype():
    x = torch.linspace(-4, 4, 257)
    exact = torch.nn.functional.gelu(x, approximate="none")
    tanh = torch.nn.functional.gelu(x, approximate="tanh")
    gelu = activations.get_activation("gelu")
    assert torch.equal(gelu(x), exact)
    assert torch.equal(gelu(x.bfloat16()), torch.nn.functional.gelu(x.bfloat16(), approximate="tanh"))
    assert not torch.equal(exact, tanh)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_matches_jax(dtype):
    """f32 statistics, eps 1e-5, affine, result in the input dtype. f32:
    2e-6 absolute (summation order); bf16: one bf16 ulp of the result."""
    from dpot_tpu.ops.norms import group_norm as jax_gn

    x = rand((2, 8, 8, 64), shift=1.5, scale=2.0)
    s, b = rand((64,), 1, 0.1, 1.0), rand((64,), 2, 0.1)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = norms.group_norm(xt, torch.from_numpy(s), torch.from_numpy(b), 8)
    assert got.dtype == xt.dtype
    want = np.asarray(jax_gn(jnp.asarray(x, getattr(jnp, dtype)), s, b, 8), np.float32)
    rtol = 1e-6 if dtype == "float32" else 2.0**-7
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-6, rtol=rtol)


def test_group_norm_is_torch_group_norm():
    x = rand((2, 6, 5, 32), 3)
    s, b = rand((32,), 4), rand((32,), 5)
    got = norms.group_norm(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b), 4)
    ref = torch.nn.functional.group_norm(
        torch.from_numpy(x).permute(0, 3, 1, 2), 4, torch.from_numpy(s), torch.from_numpy(b)
    ).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, ref, atol=2e-6, rtol=1e-5)


def test_instance_stats_match_jax():
    """ddof=1, eps added to sigma; f32, 1e-6 relative."""
    from dpot_tpu.ops.norms import instance_stats as jax_stats

    x = rand((2, 8, 8, 3, 4), 6, 2.0, 0.5)
    mu, sigma = norms.instance_stats(torch.from_numpy(x), dims=(1, 2, 3))
    jmu, jsigma = jax_stats(jnp.asarray(x), axes=(1, 2, 3))
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(jsigma), rtol=1e-6)
    xt = torch.from_numpy(x)
    torch.testing.assert_close(sigma[:, 0, 0, 0], xt.std(dim=(1, 2, 3)) + 1e-6)


def test_initializers_draw_the_reference_distributions():
    """Moments of large draws: the bounds are exact, the means and standard
    deviations within 5 standard errors of the expected values."""
    g = torch.Generator().manual_seed(0)
    n = 200_000
    u = initializers.torch_uniform((n,), 64, g)
    assert u.abs().max() <= 1 / 8 and abs(u.std().item() - (1 / 8) / math.sqrt(3)) < 1e-3
    su = initializers.scaled_uniform((n,), 0.5, g)
    assert su.min() >= 0 and su.max() < 0.5 and abs(su.mean().item() - 0.25) < 5 * 0.144 / math.sqrt(n)
    sn = initializers.scaled_normal((n,), 0.1, g)
    assert abs(sn.std().item() - 0.1) < 5 * 0.1 / math.sqrt(2 * n)
    # the cutoffs are absolute: at std 0.02 the +-2 window leaves the std whole
    tn = initializers.trunc_normal((n,), g)
    assert tn.abs().max() <= 2.0 and abs(tn.std().item() - 0.02) < 5 * 0.02 / math.sqrt(2 * n)
    tight = initializers.trunc_normal((n,), g, std=1.0, a=-0.5, b=0.5)
    assert tight.min() >= -0.5 and tight.max() <= 0.5 and tight.std() < 0.3


def test_gamma_geometric_matches_jax():
    from dpot_tpu.ops.initializers import gamma_geometric as jax_gamma

    want = np.asarray(jax_gamma()(None, (1, 48)))
    np.testing.assert_allclose(initializers.gamma_geometric(48).numpy(), want, rtol=1e-6)


def test_initializers_follow_the_generator():
    a = initializers.scaled_uniform((16,), 1.0, torch.Generator().manual_seed(3))
    b = initializers.scaled_uniform((16,), 1.0, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)


@pytest.mark.parametrize("H,W,modes", [(16, 16, 32), (8, 12, 4), (4, 4, 8)])
def test_combined_spectral_ops_equal_the_jax_operators(H, W, modes):
    from dpot_tpu.ops.spectral import _combined_spectral_ops

    kh, kw = spectral.kept_modes(H, W, modes)
    A, Ainv = spectral.combined_spectral_ops_np(H, W, kh, kw)
    jA, jAinv = _combined_spectral_ops(H, W, kh, kw)
    np.testing.assert_array_equal(A, jA)
    np.testing.assert_array_equal(Ainv, jAinv)


def test_spectral_ops_are_cached_per_dtype_and_device():
    """An eager forward must not copy the operators from the host again."""
    cpu = torch.device("cpu")
    a = spectral.combined_spectral_ops(8, 8, 8, 5, torch.float32, cpu)
    b = spectral.combined_spectral_ops(8, 8, 8, 5, torch.float32, cpu)
    c = spectral.combined_spectral_ops(8, 8, 8, 5, torch.bfloat16, cpu)
    assert a[0] is b[0] and a[1] is b[1]
    assert c[0].dtype == torch.bfloat16 and c[0] is not a[0]


def test_complex_as_real_weight_matches_jax():
    from dpot_tpu.ops.spectral import _complex_as_real_weight

    wr, wi = rand((3, 4, 5), 7), rand((3, 4, 5), 8)
    got = spectral.complex_as_real_weight(torch.from_numpy(wr), torch.from_numpy(wi))
    np.testing.assert_array_equal(got.numpy(), np.asarray(_complex_as_real_weight(wr, wi)))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_afno_filter_2d_matches_jax(compute):
    """The combined-operator mixer. f32: 2e-5 absolute (summation order).
    bf16 compute (bf16 DFT operands and mode MLP in both packages):
    relative L2 error at most 1e-2, a few bf16 roundings apart."""
    from dpot_tpu.ops.activations import get_activation as jax_act
    from dpot_tpu.ops.spectral import afno_filter_2d as jax_filter

    B, H, W, C, nb, modes = 2, 8, 8, 64, 4, 4
    bs = C // nb
    x = rand((B, H, W, C), 9)
    w = [rand(s, 10 + i, 0.2) for i, s in enumerate(
        [(2, nb, bs, bs), (2, nb, bs), (2, nb, bs, bs), (2, nb, bs)])]
    tdt, jdt = getattr(torch, compute), getattr(jnp, compute)
    got = spectral.afno_filter_2d(
        torch.from_numpy(x), *map(torch.from_numpy, w), modes,
        activations.get_activation("gelu"), compute_dtype=tdt,
    ).numpy()
    want = np.asarray(jax_filter(
        jnp.asarray(x), *map(jnp.asarray, w), modes, jax_act("gelu"), compute_dtype=jdt,
    ))
    if compute == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    else:
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-2

