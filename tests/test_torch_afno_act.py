"""The AFNO mode MLP applies the model's `act`, in the port as in the JAX
package: the fused op's plain version, its VJP and the whole DPOTNet, for
every activation of the registry (dpot_tpu_torch/ops/activations.py).

The mixer weights are drawn from N(0, 0.2^2) with numpy, so that the mode
MLP moves the output; at the init's scale (1/bs^2) it hardly does, and an
activation that is wrong there goes unseen. On the CPU the fused op runs
its plain version; the kernels are held to it on the card by
tests/test_torch_gpu.py and chip_smoke.py.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from dpot_tpu.models import build_model as jax_build_model
from dpot_tpu.train.interop import dpot_params_from_torch
from dpot_tpu_torch.models import build_model
from dpot_tpu_torch.ops.activations import _ACTIVATIONS
from dpot_tpu_torch.ops.cuda import afno_fused
from dpot_tpu_torch.ops.spectral import combined_spectral_ops, kept_modes

ACTS = sorted(_ACTIVATIONS)
SMALL = dict(img_size=32, patch_size=4, in_channels=3, out_channels=3,
             in_timesteps=6, out_timesteps=2, embed_dim=64, depth=2, n_blocks=4,
             modes=8, n_cls=5)
MIXER_SCALE = 0.2


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test files at once; torch's CPU ops here keep
    to two threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_registry_and_kernel_ids_cover_the_same_activations():
    assert sorted(afno_fused.ACT_IDS) == ACTS
    ids = {afno_fused.act_id(a, True) for a in ACTS} | {afno_fused.act_id("gelu", False)}
    assert ids == set(range(9))
    with pytest.raises(ValueError, match="unknown activation"):
        afno_fused.act_id("swish", True)


def with_strong_mixer(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Redraw every AFNO weight and bias from N(0, MIXER_SCALE^2)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for blk in model.blocks:
            for p in (blk.filter.w1, blk.filter.b1, blk.filter.w2, blk.filter.b2):
                p.copy_(torch.from_numpy(
                    (MIXER_SCALE * rng.standard_normal(tuple(p.shape))).astype(np.float32)))
    return model


def port_and_jax(act: str, dtype: str, seed: int = 0):
    x = np.random.default_rng(seed + 1).standard_normal((2, 32, 32, 6, 3)).astype(np.float32)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tm = with_strong_mixer(
        build_model("DPOT", act=act, dtype=tdt, device="cpu", seed=seed, **SMALL), seed)
    jm = jax_build_model("DPOT", act=act, dtype=jdt, **SMALL)
    sd = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
    params = dpot_params_from_torch(sd, depth=SMALL["depth"], normalize=False)
    with torch.no_grad():
        ty, _ = tm(torch.from_numpy(x))
    jy, _ = jm.apply(params, jnp.asarray(x))
    return ty.numpy(), np.asarray(jy)


@pytest.mark.parametrize("act", ACTS)
def test_dpotnet_f32_matches_jax_for_each_activation(act):
    """f32, the interop bar of PARITY.md: 2e-4 absolute. The mode MLP here
    moves the output by far more than that, so a wrong activation fails."""
    ty, jy = port_and_jax(act, "float32")
    assert ty.shape == jy.shape == (2, 32, 32, 2, 3)
    np.testing.assert_allclose(ty, jy, atol=2e-4, rtol=0)


@pytest.mark.parametrize("act", ACTS)
def test_dpotnet_bf16_matches_jax_bf16_for_each_activation(act):
    """bf16 compute in both packages, which round at different points (the
    port's fused op as the TPU kernel does, the JAX model through XLA):
    relative L2 at most 2e-2."""
    ty, jy = port_and_jax(act, "bfloat16", seed=3)
    assert np.isfinite(ty).all()
    assert rel_l2(ty, jy) < 2e-2


def afno_args(act_seed: int, requires_grad: bool = False):
    """fused_gn_afno arguments at a small geometry, seeded with numpy."""
    B, H, W, C, nb, modes, groups = 2, 8, 8, 64, 4, 4, 4
    bs = C // nb
    rng = np.random.default_rng(act_seed)

    def t(shape, scale=1.0, shift=0.0):
        a = (shift + scale * rng.standard_normal(shape)).astype(np.float32)
        return torch.from_numpy(a).requires_grad_(requires_grad)

    kh, kw = kept_modes(H, W, modes)
    A, Ainv = combined_spectral_ops(H, W, kh, kw, torch.float32, torch.device("cpu"))
    args = (t((B, H * W, C)), t((C,), 0.1, 1.0), t((C,), 0.1), A, Ainv,
            t((2, nb, bs, bs), MIXER_SCALE), t((2, nb, bs), MIXER_SCALE),
            t((2, nb, bs, bs), MIXER_SCALE), t((2, nb, bs), MIXER_SCALE))
    g = torch.from_numpy(rng.standard_normal((B, H * W, C)).astype(np.float32))
    return args, kh * kw, groups, g, (H, W, modes)


@pytest.mark.parametrize("act", ACTS)
def test_plain_version_matches_group_norm_plus_afno_filter(act):
    """The fused op's plain version in f32 (gelu: the erf form) against the
    JAX f32 path it replaces: group_norm, then afno_filter_2d with the
    registry's activation and the residual of the normed input. 2e-5
    absolute: f32 throughout, another summation order."""
    from dpot_tpu.ops.activations import get_activation
    from dpot_tpu.ops.norms import group_norm
    from dpot_tpu.ops.spectral import afno_filter_2d

    args, K, groups, _, (H, W, modes) = afno_args(7)
    got = afno_fused.fused_gn_afno(*args, K, groups, approximate=False, act=act)
    x, gs, gb = (t.numpy() for t in args[:3])
    B, HW, C = x.shape
    xn = group_norm(jnp.asarray(x).reshape(B, H, W, C), jnp.asarray(gs), jnp.asarray(gb), groups)
    want = afno_filter_2d(xn, *(jnp.asarray(t.numpy()) for t in args[5:]), modes,
                          get_activation(act), compute_dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(B, HW, C),
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("act", ACTS)
def test_vjp_matches_autograd_through_the_plain_version(act):
    """f32: the VJP's cotangents of x, gscale, gbias, w1, b1, w2, b2 against
    torch.autograd through fused_gn_afno_ref, 1e-4 relative L2 each (the
    same f32 arithmetic in another order)."""
    args, K, groups, g, _ = afno_args(11, requires_grad=True)
    approx = act == "gelu"  # both gelu forms are covered: tanh here, erf elsewhere
    out = afno_fused.fused_gn_afno_ref(*args, K, groups, approx, act)
    leaves = [args[i] for i in (0, 1, 2, 5, 6, 7, 8)]
    want = torch.autograd.grad(out, leaves, g)
    got = afno_fused.fused_gn_afno_vjp(g, *(t.detach() for t in args), K, groups, approx, act)
    for name, a, w in zip(("x", "gscale", "gbias", "w1", "b1", "w2", "b2"), got, want):
        assert rel_l2(a.numpy(), w.numpy()) <= 1e-4, name


def test_model_passes_its_act_to_the_fused_op(monkeypatch):
    """AFNO2D hands the block's act and the dtype's gelu form to the op."""
    seen = []
    real = afno_fused.fused_gn_afno

    def spy(*args, approximate, act):
        seen.append((approximate, act))
        return real(*args, approximate=approximate, act=act)

    from dpot_tpu_torch.models import dpot

    monkeypatch.setattr(dpot, "fused_gn_afno", spy)
    x = torch.zeros((1, 32, 32, 6, 3))
    for act, dtype in (("silu", torch.float32), ("gelu", torch.bfloat16)):
        m = build_model("DPOT", act=act, dtype=dtype, device="cpu", **SMALL)
        with torch.no_grad():
            m(x)
    assert seen == [(False, "silu")] * 2 + [(True, "gelu")] * 2
