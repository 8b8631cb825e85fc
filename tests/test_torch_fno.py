"""The port's FNO2d and FNO3d (dpot_tpu_torch/models/fno.py) against the JAX
package's (dpot_tpu/models/fno.py) on the same weights and inputs, and their
reference-layout weights (FNO3d's torch.cfloat spectral weights included).

Weights are drawn by the port, moved off their init by seeded noise, and
carried into JAX by `fno2d_params_from_torch` / `fno3d_params_from_torch`
(FNO3d's real-stacked weights made complex first, as the reference stores
them). f32 at 2e-4 absolute (PARITY.md), bf16 at 2e-2 relative L2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpot_tpu.models import build_model as jax_build_model
from dpot_tpu.train.interop import fno2d_params_from_torch, fno3d_params_from_torch
from dpot_tpu_torch.models import build_model
from dpot_tpu_torch.ops.cuda.afno_fused import fused_gn_afno
from dpot_tpu_torch.train.interop import params_from_any, state_dict_from_jax

CFG2 = dict(img_size=16, patch_size=1, in_channels=2, in_timesteps=4, out_timesteps=1,
            embed_dim=16, depth=2, modes=4, n_cls=2)
CFG3 = dict(img_size=8, in_channels=2, in_timesteps=3, out_timesteps=1, embed_dim=8,
            depth=2, modes=2)


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


def perturbed(model, seed=1, scale=0.1):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(scale * torch.randn(p.shape, generator=g))
    return model


def numpy_sd(model):
    return {k: v.detach().float().numpy() for k, v in model.state_dict().items()}


def as_reference_3d(sd):
    """The port's FNO3d state dict as the reference stores it: complex64
    spectral weights (I, O, m1, m2, m3)."""
    return {k: (v[0] + 1j * v[1]).astype(np.complex64) if ".weights" in k else v
            for k, v in sd.items()}


def fno2d_params(model, **kw):
    return fno2d_params_from_torch(numpy_sd(model), n_layers=len(model.convs), **kw)


@pytest.mark.parametrize("shape,modes", [((2, 32, 24, 8), (6, 5)), ((1, 8, 8, 6, 4), (2, 3, 2))])
def test_spectral_conv_alone_matches_jax(shape, modes):
    """The spectral convolution on its own (in a model its init-scale
    weights make it a small part of the output), 2D and 3D."""
    from dpot_tpu.models.fno import SpectralConv2d, SpectralConv3d
    from dpot_tpu_torch.models.fno import SpectralConv

    spec = SpectralConv(shape[-1], modes, torch.Generator().manual_seed(1))
    x = rand(shape, seed=len(modes))
    with torch.no_grad():
        got = spec(torch.from_numpy(x)).numpy()
    jax_cls = SpectralConv2d if len(modes) == 2 else SpectralConv3d
    want = jax_cls(shape[-1], shape[-1], *modes).apply(
        {"params": {k: v.detach().numpy() for k, v in spec.named_parameters()}}, jnp.asarray(x))
    assert rel_l2(got, np.asarray(want)) <= 1e-5


@pytest.mark.parametrize("kw", [dict(), dict(use_ln=1), dict(patch_size=2, normalize=True)],
                         ids=["plain", "use_ln", "patch2_normalize"])
def test_fno2d_forward_f32_matches_jax(kw):
    """use_ln adds GroupNorm(4) layers; at a patch above 1 both return the
    latent's resolution."""
    cfg = {**CFG2, **kw}
    tm = perturbed(build_model("FNO", device="cpu", seed=0, **cfg))
    jm = jax_build_model("FNO", **cfg)
    x = 2.0 * rand((2, 16, 16, 4, 2)) + 1.0
    with torch.no_grad():
        ty, tc = tm(torch.from_numpy(x))
    p = fno2d_params(tm, normalize=bool(kw.get("normalize")), use_ln=bool(kw.get("use_ln")))
    jy, jc = jm.apply(p, jnp.asarray(x))
    h = 16 // cfg["patch_size"]
    assert ty.shape == jy.shape == (2, h, h, 1, 2)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=2e-4, rtol=0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-4, rtol=0)


def test_fno2d_forward_bf16_matches_jax_bf16():
    tm = perturbed(build_model("FNO", device="cpu", seed=2, dtype=torch.bfloat16, **CFG2))
    jm = jax_build_model("FNO", dtype=jnp.bfloat16, **CFG2)
    x = rand((2, 16, 16, 4, 2), seed=3)
    with torch.no_grad():
        ty, _ = tm(torch.from_numpy(x))
    jy, _ = jm.apply(fno2d_params(tm), jnp.asarray(x))
    assert rel_l2(ty.numpy(), np.asarray(jy)) <= 2e-2


@pytest.mark.parametrize("use_ln", [0, 1])
def test_fno3d_forward_matches_jax(use_ln):
    """Pred-only, (B, X, Y, Z, T, C) in and out."""
    tm = perturbed(build_model("FNO3D", device="cpu", seed=4, use_ln=use_ln, **CFG3))
    jm = jax_build_model("FNO3D", use_ln=use_ln, **CFG3)
    x = rand((2, 8, 8, 8, 3, 2), seed=5)
    with torch.no_grad():
        ty = tm(torch.from_numpy(x))
    p = fno3d_params_from_torch(as_reference_3d(numpy_sd(tm)), n_layers=2,
                                use_ln=bool(use_ln))
    jy = jm.apply(p, jnp.asarray(x))
    assert isinstance(ty, torch.Tensor) and ty.shape == (2, 8, 8, 8, 1, 2)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=2e-4, rtol=0)


@pytest.mark.parametrize("family", ["FNO", "FNO3D"])
def test_state_dict_from_jax_inverts_the_fno_converters(family):
    if family == "FNO":
        model = perturbed(build_model("FNO", device="cpu", seed=6, use_ln=1, normalize=True,
                                      **CFG2))
        p = fno2d_params(model, normalize=True, use_ln=True)
    else:
        model = perturbed(build_model("FNO3D", device="cpu", seed=6, use_ln=1, **CFG3))
        p = fno3d_params_from_torch(as_reference_3d(numpy_sd(model)), n_layers=2,
                                    use_ln=True)
    sd = model.state_dict()
    back = state_dict_from_jax(jax.device_get(p))
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_fno3d_cfloat_reference_loads_as_jax_splits_it(tmp_path):
    """A reference .pth with torch.cfloat spectral weights loads strictly
    into the port's real-stacked layout, equal to what the JAX package's
    fno3d_params_from_torch makes of the same file."""
    ref = build_model("FNO3D", device="cpu", seed=7, **CFG3)
    g = torch.Generator().manual_seed(8)
    sd = {k: torch.complex(torch.randn(v.shape[1:], generator=g),
                           torch.randn(v.shape[1:], generator=g)) if ".weights" in k else v
          for k, v in ref.state_dict().items()}
    assert sd["spectral_convs.0.weights1"].dtype == torch.complex64
    path = tmp_path / "fno3d_ref.pth"
    torch.save({"args": None, "model": {f"module.{k}": v for k, v in sd.items()}}, path)
    model = build_model("FNO3D", device="cpu", seed=9, **CFG3)
    model.load_state_dict(params_from_any(str(path), model), strict=True)
    want = state_dict_from_jax(fno3d_params_from_torch(
        {k: v.numpy() for k, v in sd.items()}, n_layers=2))
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_fno_forwards_launch_no_kernel():
    before = fused_gn_afno.launches
    with torch.no_grad():
        build_model("FNO", device="cpu", **CFG2)(torch.zeros(1, 16, 16, 4, 2))
        build_model("FNO3D", device="cpu", **CFG3)(torch.zeros(1, 8, 8, 8, 3, 2))
    assert fused_gn_afno.launches == before


def test_remat_is_refused_for_the_families_without_an_afno_trunk():
    for family, cfg in (("FNO", CFG2), ("FNO3D", CFG3), ("UNet", CFG2)):
        with pytest.raises(ValueError, match="remat"):
            build_model(family, device="cpu", remat=True, **cfg)
