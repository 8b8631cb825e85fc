"""The port's fused GroupNorm+AFNO kernel module
(dpot_tpu_torch/ops/cuda/afno_fused.py) against the JAX package.

On the CPU the wrapper runs its plain PyTorch version, which repeats the
CUDA kernel's arithmetic and rounding points. Its semantics are pinned here
against the TPU kernel run in interpret mode (f32 operands, as the JAX
package's own tests run it), against the kernel's XLA reference, and, for
the erf-GELU instance, against GroupNorm + afno_filter_2d. bf16 operands
cannot be checked against JAX on this CPU (XLA's CPU dot has no
bf16 x bf16 -> f32), so the bf16 kernel is held against its plain version on
the card by chip_smoke.py and tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from dpot_tpu_torch.ops.cuda.afno_fused import fused_gn_afno
from dpot_tpu_torch.ops.spectral import combined_spectral_ops, kept_modes


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test files at once, some of them timing host
    throughput; torch's CPU ops here keep to two threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_case(B=2, H=8, W=8, C=128, nb=2, modes=8, groups=8, seed=0, scale=0.05):
    """Seeded numpy inputs in the reference layout."""
    bs = C // nb
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        x=rng.standard_normal((B, H * W, C)).astype(f),
        gs=(1.0 + 0.1 * rng.standard_normal(C)).astype(f),
        gb=(0.1 * rng.standard_normal(C)).astype(f),
        w1=(rng.standard_normal((2, nb, bs, bs)) * scale).astype(f),
        b1=(rng.standard_normal((2, nb, bs)) * scale).astype(f),
        w2=(rng.standard_normal((2, nb, bs, bs)) * scale).astype(f),
        b2=(rng.standard_normal((2, nb, bs)) * scale).astype(f),
        H=H, W=W, modes=modes, groups=groups,
    )


def port_args(c, dtype=torch.float32):
    kh, kw = kept_modes(c["H"], c["W"], c["modes"])
    A, Ainv = combined_spectral_ops(c["H"], c["W"], kh, kw, dtype, torch.device("cpu"))
    t = torch.from_numpy
    return (t(c["x"]).to(dtype), t(c["gs"]), t(c["gb"]), A, Ainv,
            t(c["w1"]), t(c["b1"]), t(c["w2"]), t(c["b2"]), kh * kw, c["groups"])


def jax_args(c):
    from dpot_tpu.ops.spectral import _combined_spectral_ops, _complex_as_real_weight

    kh, kw = kept_modes(c["H"], c["W"], c["modes"])
    A, Ainv = _combined_spectral_ops(c["H"], c["W"], kh, kw)
    w1, b1, w2, b2 = (jnp.asarray(c[k]) for k in ("w1", "b1", "w2", "b2"))
    return (
        jnp.asarray(c["x"]), jnp.asarray(c["gs"])[None], jnp.asarray(c["gb"])[None],
        jnp.asarray(A), jnp.asarray(Ainv),
        _complex_as_real_weight(w1[0], w1[1]),
        jnp.concatenate([b1[0], b1[1]], -1)[:, None, :],
        _complex_as_real_weight(w2[0], w2[1]),
        jnp.concatenate([b2[0], b2[1]], -1)[:, None, :],
        kh * kw, c["groups"],
    )


@pytest.mark.parametrize("shape", [
    dict(B=2, H=8, W=8, C=128, nb=2, modes=8, groups=8),
    dict(B=3, H=4, W=8, C=64, nb=4, modes=3, groups=4),
    # AFNO blocks of 256 channels (the wide kernel's): one block and group,
    # and DPOT-H's layout of one group per block
    dict(B=2, H=8, W=8, C=256, nb=1, modes=4, groups=1),
    dict(B=2, H=8, W=8, C=512, nb=2, modes=4, groups=2),
    # AFNO blocks of 96 channels (the kernels for DPOT-L's blocks) with
    # GroupNorm groups that straddle blocks: one group over a block pair,
    # and two groups each over a pair, as DPOT-L's groups of 192
    dict(B=2, H=8, W=8, C=192, nb=2, modes=4, groups=1),
    dict(B=2, H=8, W=8, C=384, nb=4, modes=4, groups=2),
])
def test_f32_matches_tpu_kernel_interpret_and_xla_reference(shape, monkeypatch):
    """approximate=True (tanh-GELU) in f32 == the TPU kernel in interpret
    mode (f32 operands) and its XLA reference. Tolerance 1e-5 absolute:
    the same f32 arithmetic, summed in another order."""
    monkeypatch.setenv("DPOT_PALLAS_INTERPRET", "1")
    from dpot_tpu.ops.pallas.afno_fused import _xla_reference
    from dpot_tpu.ops.pallas.afno_fused import fused_gn_afno as jax_fused

    c = make_case(**shape)
    got = fused_gn_afno(*port_args(c), approximate=True).numpy()
    ja = jax_args(c)
    want_kernel = np.asarray(jax_fused(*ja))
    want_ref = np.asarray(_xla_reference(*ja[:9], K=ja[9], groups=ja[10]))
    np.testing.assert_allclose(got, want_kernel, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, want_ref, atol=1e-5, rtol=0)


def test_erf_variant_matches_group_norm_plus_afno_filter():
    """approximate=False (erf-GELU) in f32 == the JAX f32 model path:
    group_norm then afno_filter_2d with the residual of the normed input.
    Tolerance 2e-5 absolute: f32 throughout, another summation order."""
    from dpot_tpu.ops.activations import get_activation
    from dpot_tpu.ops.norms import group_norm
    from dpot_tpu.ops.spectral import afno_filter_2d

    c = make_case(B=2, H=8, W=8, C=128, nb=4, modes=4, seed=3, scale=0.2)
    got = fused_gn_afno(*port_args(c), approximate=False).numpy()
    B, HW, C = c["x"].shape
    x4 = jnp.asarray(c["x"]).reshape(B, c["H"], c["W"], C)
    xn = group_norm(x4, jnp.asarray(c["gs"]), jnp.asarray(c["gb"]), c["groups"])
    want = afno_filter_2d(
        xn, *(jnp.asarray(c[k]) for k in ("w1", "b1", "w2", "b2")), c["modes"],
        get_activation("gelu"), compute_dtype=jnp.float32,
    )
    np.testing.assert_allclose(got, np.asarray(want).reshape(B, HW, C), atol=2e-5, rtol=0)


def test_bf16_plain_version_rounds_like_the_tpu_kernel():
    """Under bf16 operands the plain version rounds xn, z, h and o to bf16
    and keeps the residual xn in f32. Against the f32 run of the same
    inputs its relative L2 error is that of a few bf16 roundings: at most
    1e-2 (bf16 keeps 8 significant bits, 2^-8 = 3.9e-3 per rounding)."""
    c = make_case(B=2, H=8, W=8, C=128, nb=2, modes=8, seed=5, scale=0.1)
    c["x"] = torch.from_numpy(c["x"]).to(torch.bfloat16).float().numpy()
    lo = fused_gn_afno(*port_args(c, torch.bfloat16), approximate=True)
    hi = fused_gn_afno(*port_args(c, torch.float32), approximate=True)
    assert lo.dtype == torch.bfloat16 and lo.shape == hi.shape
    rel = ((lo.float() - hi).norm() / hi.norm()).item()
    assert 0 < rel < 1e-2


def test_cpu_tensors_never_count_as_launches():
    c = make_case()
    before = fused_gn_afno.launches
    for approx in (True, False):
        fused_gn_afno(*port_args(c), approximate=approx)
    assert fused_gn_afno.launches == before


def _bad(args, i, value):
    args = list(args)
    args[i] = value
    return args


@pytest.mark.parametrize("case,error", [
    ("x_rank", ValueError),
    ("x_dtype", TypeError),
    ("A_dtype", TypeError),
    ("A_shape", ValueError),
    ("gscale_shape", ValueError),
    ("hidden_factor", ValueError),
    ("groups", ValueError),
    ("noncontiguous", ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(case, error):
    c = make_case()
    a = port_args(c)
    x, gs, A, w1 = a[0], a[1], a[3], a[5]
    bad = {
        "x_rank": lambda: _bad(a, 0, x[0]),
        "x_dtype": lambda: _bad(a, 0, x.to(torch.float16)),
        "A_dtype": lambda: _bad(a, 3, A.to(torch.bfloat16)),
        "A_shape": lambda: _bad(a, 3, A[:-2].contiguous()),
        "gscale_shape": lambda: _bad(a, 1, gs[None]),
        "hidden_factor": lambda: _bad(a, 5, torch.cat([w1, w1], dim=-1)),
        "groups": lambda: _bad(a, 10, 7),
        "noncontiguous": lambda: _bad(a, 0, x.transpose(0, 1).contiguous().transpose(0, 1)),
    }[case]()
    with pytest.raises(error):
        fused_gn_afno(*bad)


def test_latent_above_combined_limit_names_the_roadmap_item():
    """The combined operators stop at 4096 px; larger latents take the
    separable route (ROADMAP item 3), which builds no operators."""
    with pytest.raises(ValueError, match="separable route.*item 3"):
        combined_spectral_ops(128, 64, 32, 32, torch.float32, torch.device("cpu"))
