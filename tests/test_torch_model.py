"""The port's DPOTNet (dpot_tpu_torch/models) against the JAX package's, on
the same weights and inputs, plus the weight interop and the device rule.

Weights are drawn by the port from a seed and carried into the JAX model
through the JAX package's own `dpot_params_from_torch`; inputs come from
numpy seeds. f32 is held at the interop bar of PARITY.md, 2e-4 absolute.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from dpot_tpu.models import build_model as jax_build_model
from dpot_tpu.train.interop import dpot_params_from_torch
from dpot_tpu_torch.models import build_model
from dpot_tpu_torch.ops.cuda.afno_fused import fused_gn_afno
from dpot_tpu_torch.train.interop import (
    params_from_any,
    state_dict_from_jax,
    strip_module_prefix,
)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test files at once, some of them timing host
    throughput; torch's CPU ops here keep to two threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


SMALL = dict(img_size=32, patch_size=4, in_channels=3, out_channels=3,
             in_timesteps=6, out_timesteps=2, embed_dim=64, depth=2, n_blocks=4,
             modes=8, n_cls=5)


def jax_params(model: torch.nn.Module, depth: int, normalize: bool) -> dict:
    sd = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    return dpot_params_from_torch(sd, depth=depth, normalize=normalize)


def both(x, normalize=False, dtype="float32", seed=0, cfg=SMALL):
    """(port output, JAX output) of the same weights on input x."""
    kw = dict(cfg)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tm = build_model("DPOT", normalize=normalize, dtype=tdt, device="cpu", seed=seed, **kw)
    jm = jax_build_model("DPOT", normalize=normalize, dtype=jdt, **kw)
    p = jax_params(tm, len(tm.blocks), normalize)
    with torch.no_grad():
        ty, tc = tm(torch.from_numpy(x))
    jy, jc = jm.apply(p, jnp.asarray(x))
    return (ty.numpy(), tc.numpy()), (np.asarray(jy), np.asarray(jc))


def rand_x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("normalize", [False, True])
def test_forward_f32_matches_jax(normalize):
    x = 3.0 * rand_x((2, 32, 32, 6, 3)) + 1.0
    (ty, tc), (jy, jc) = both(x, normalize=normalize)
    assert ty.shape == jy.shape == (2, 32, 32, 2, 3) and ty.dtype == np.float32
    np.testing.assert_allclose(ty, jy, atol=2e-4, rtol=0)
    np.testing.assert_allclose(tc, jc, atol=2e-4, rtol=0)


@pytest.mark.parametrize("normalize", [False, True])
def test_forward_bf16_matches_jax_bf16(normalize):
    """bf16 compute in both packages. They round at different points (the
    port's fused kernel rounds xn, z, h and o to bf16 as the TPU kernel
    does; the JAX bf16 model runs its XLA-composed path), so the two differ
    by a few bf16 roundings: relative L2 error at most 2e-2."""
    x = rand_x((2, 32, 32, 6, 3), seed=1)
    (ty, _), (jy, _) = both(x, normalize=normalize, dtype="bfloat16")
    assert np.isfinite(ty).all() and ty.dtype == np.float32
    rel = np.linalg.norm(ty - jy) / np.linalg.norm(jy)
    assert rel < 2e-2


# AFNO blocks of 256 channels, DPOT-H's (the card runs its bf16 mixer on
# afno_hopper_wide.cu): embed 512 in 2 blocks, depth 2, 64^2 grid, patch 8
WIDE_BLOCKS = dict(SMALL, img_size=64, patch_size=8, embed_dim=512, depth=2, n_blocks=2,
                   modes=4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_with_256_channel_blocks_matches_jax(dtype):
    """f32 at the interop bar (2e-4 absolute); bf16 at the bf16 bar above
    (relative L2 below 2e-2: the two packages round at different points)."""
    x = rand_x((2, 64, 64, 6, 3), seed=7)
    (ty, tc), (jy, jc) = both(x, dtype=dtype, cfg=WIDE_BLOCKS)
    assert ty.shape == jy.shape == (2, 64, 64, 2, 3) and np.isfinite(ty).all()
    if dtype == "float32":
        np.testing.assert_allclose(ty, jy, atol=2e-4, rtol=0)
        np.testing.assert_allclose(tc, jc, atol=2e-4, rtol=0)
    else:
        assert np.linalg.norm(ty - jy) / np.linalg.norm(jy) < 2e-2


# DPOT-L's layout in miniature: 16 AFNO blocks and GroupNorm(8), so that each
# group spans two blocks (the card runs its mixer on afno_hopper_l.cu and
# afno_hopper_f32_l.cu): embed 192 in blocks of 12, depth 2, 32^2 grid
L_LAYOUT = dict(SMALL, embed_dim=192, depth=2, n_blocks=16, modes=4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_with_groups_spanning_two_blocks_matches_jax(dtype):
    """f32 at the interop bar (2e-4 absolute); bf16 at the bf16 bar above
    (relative L2 below 2e-2)."""
    x = rand_x((2, 32, 32, 6, 3), seed=8)
    (ty, tc), (jy, jc) = both(x, dtype=dtype, cfg=L_LAYOUT)
    assert ty.shape == jy.shape == (2, 32, 32, 2, 3) and np.isfinite(ty).all()
    if dtype == "float32":
        np.testing.assert_allclose(ty, jy, atol=2e-4, rtol=0)
        np.testing.assert_allclose(tc, jc, atol=2e-4, rtol=0)
    else:
        assert np.linalg.norm(ty - jy) / np.linalg.norm(jy) < 2e-2


def test_forward_ti_entry_config_matches_jax():
    """The flagship geometry of __graft_entry__.entry() at full width and
    depth: preset Ti on a 128^2 grid, patch 8, T_in 10, 4 channels."""
    x = rand_x((1, 128, 128, 10, 4), seed=2)
    ti = dict(preset="Ti", img_size=128, patch_size=8, in_channels=4,
              out_channels=4, in_timesteps=10, out_timesteps=1, modes=32, n_cls=12)
    (ty, tc), (jy, jc) = both(x, cfg=ti)
    assert ty.shape == (1, 128, 128, 1, 4)
    np.testing.assert_allclose(ty, jy, atol=2e-4, rtol=0)
    np.testing.assert_allclose(tc, jc, atol=2e-4, rtol=0)


def test_state_dict_from_jax_inverts_dpot_params_from_torch():
    """Exact round trip, leaf for leaf, and a strict load into the port."""
    for normalize in (False, True):
        m = build_model("DPOT", normalize=normalize, device="cpu", seed=3, **SMALL)
        p = jax_params(m, SMALL["depth"], normalize)
        sd = state_dict_from_jax(p)
        back = dpot_params_from_torch(
            {k: v.numpy() for k, v in sd.items()}, depth=SMALL["depth"], normalize=normalize
        )
        la, ta = jax.tree.flatten(p)
        lb, tb = jax.tree.flatten(back)
        assert ta == tb
        for a, b in zip(la, lb):
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        fresh = build_model("DPOT", normalize=normalize, device="cpu", seed=4, **SMALL)
        fresh.load_state_dict(sd, strict=True)
        for k, v in m.state_dict().items():
            torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)


def test_jax_initialized_params_serve_through_the_port():
    """Params initialised by the JAX package (not by the port) load into the
    port and give the JAX forward."""
    jm = jax_build_model("DPOT", **SMALL)
    x = rand_x((2, 32, 32, 6, 3), seed=5)
    p = jm.init(jax.random.key(0), jnp.asarray(x))
    jy, _ = jm.apply(p, jnp.asarray(x))
    tm = build_model("DPOT", device="cpu", **SMALL)
    tm.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, p)), strict=True)
    with torch.no_grad():
        ty, _ = tm(torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=2e-4, rtol=0)


def test_reference_pth_loads_strict(tmp_path):
    """A reference-layout .pth ({'args', 'model', 'optimizer'} with DDP
    prefixes) loads with no conversion."""
    import argparse

    m = build_model("DPOT", device="cpu", seed=6, **SMALL)
    sd = {f"module.{k}": v for k, v in m.state_dict().items()}
    path = tmp_path / "model.pth"
    torch.save({"args": argparse.Namespace(width=64), "model": sd, "optimizer": {}}, path)
    fresh = build_model("DPOT", device="cpu", seed=7, **SMALL)
    fresh.load_state_dict(params_from_any(str(path), fresh), strict=True)
    for k, v in m.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)
    assert strip_module_prefix({"module.a": 1, "b": 2}) == {"a": 1, "b": 2}


def test_parameter_layout_is_the_reference_state_dict():
    m = build_model("DPOT", normalize=True, device="cpu", **SMALL)
    shapes = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    E, D, p, bs = 3 * 4 + 3, 64, 4, 16
    assert shapes["patch_embed.proj.0.weight"] == (E, 3 + 3, p, p)
    assert shapes["patch_embed.proj.2.weight"] == (D, E, 1, 1)
    assert shapes["pos_embed"] == (1, D, 8, 8)
    assert shapes["time_agg_layer.w"] == (6, D, D)
    assert shapes["time_agg_layer.gamma"] == (1, D)
    assert shapes["blocks.1.filter.w1"] == (2, 4, bs, bs)
    assert shapes["blocks.1.filter.b2"] == (2, 4, bs)
    assert shapes["blocks.0.mlp.0.weight"] == (D, D, 1, 1)
    assert shapes["out_layer.0.weight"] == (D, 32, p, p)
    assert shapes["out_layer.4.weight"] == (2 * 3, 32, 1, 1)
    assert shapes["cls_head.4.weight"] == (5, D)
    assert shapes["scale_feats_mu.weight"] == (D, 2 * 3)


def test_presets_match_the_jax_registry():
    from dpot_tpu.models.registry import MODEL_PRESETS as JAX_PRESETS
    from dpot_tpu_torch.models import MODEL_PRESETS

    assert MODEL_PRESETS == JAX_PRESETS


def test_seed_fixes_the_weights():
    a = build_model("DPOT", device="cpu", seed=1, **SMALL).state_dict()
    b = build_model("DPOT", device="cpu", seed=1, **SMALL).state_dict()
    c = build_model("DPOT", device="cpu", seed=2, **SMALL).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["blocks.0.filter.w1"], c["blocks.0.filter.w1"])


def test_device_rule(monkeypatch):
    """Entry points run on CUDA unless the caller asks for the CPU; with no
    GPU a CUDA request raises rather than falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model("DPOT", **SMALL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model("DPOT", device=None, **SMALL)
    with pytest.raises(ValueError):
        build_model("DPOT", device="meta", **SMALL)
    m = build_model("DPOT", device="cpu", **SMALL)
    assert all(p.device.type == "cpu" for p in m.parameters())


def test_cpu_forward_never_launches_the_kernel():
    m = build_model("DPOT", device="cpu", **SMALL)
    before = fused_gn_afno.launches
    with torch.no_grad():
        m(torch.from_numpy(rand_x((1, 32, 32, 6, 3))))
    assert fused_gn_afno.launches == before


def test_an_unknown_family_raises():
    with pytest.raises(ValueError, match="unknown model family"):
        build_model("nope", device="cpu")
