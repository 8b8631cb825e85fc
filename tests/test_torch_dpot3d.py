"""The port's DPOTNet3D (dpot_tpu_torch/models/dpot3d.py), its 3D mixer
(ops/spectral.py afno_filter_3d) and the 2D->3D inflation
(train/interop.py) against the JAX package's, on the CPU at a small size.

Weights are drawn by the port from a seed and carried into the JAX model
by the JAX package's own `dpot3d_params_from_torch`; inputs come from
numpy seeds. f32 is held at the interop bar of PARITY.md, 2e-4 absolute;
bf16 at 2e-2 relative L2, as tests/test_torch_model.py holds the 2D model
(the two packages round at different points).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpot_tpu.models import build_model as jax_build_model
from dpot_tpu.ops.activations import get_activation as jax_activation
from dpot_tpu.ops.norms import group_norm as jax_group_norm
from dpot_tpu.ops.spectral import afno_filter_3d as jax_afno_filter_3d
from dpot_tpu.train.interop import dpot3d_params_from_torch, dpot_params_from_torch
from dpot_tpu.train.interop import inflate_2d_to_3d as jax_inflate
from dpot_tpu_torch.models import build_model
from dpot_tpu_torch.ops.activations import get_activation
from dpot_tpu_torch.ops.norms import group_norm
from dpot_tpu_torch.ops.spectral import afno_filter_3d
from dpot_tpu_torch.train.interop import inflate_2d_to_3d, state_dict_from_jax

BAR = 2e-4
CFG = dict(img_size=16, patch_size=4, in_channels=2, out_channels=2, in_timesteps=3,
           out_timesteps=1, embed_dim=32, depth=2, n_blocks=4, modes=4, n_cls=1)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def rand(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def jax_params(model, normalize=False):
    sd = {k: v.detach().float().numpy() for k, v in model.state_dict().items()}
    return dpot3d_params_from_torch(sd, depth=len(model.blocks), normalize=normalize)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


# (B, X, Y, Z, C), modes, temporal_modes: the corner [:4, :4, :2]; modes
# above the grid; an odd last axis; the temporal cap at Z//2+1 (with the
# Nyquist bin of an even Z)
FILTER_CASES = {
    "corner": ((2, 8, 8, 8, 8), 4, 2),
    "modes_exceed_grid": ((1, 4, 6, 6, 8), 8, 8),
    "odd_last_axis": ((1, 6, 6, 5, 8), 4, 3),
    "temporal_cap": ((1, 6, 6, 8, 8), 4, 8),
}


@pytest.mark.parametrize("case", FILTER_CASES)
def test_afno_filter_3d_and_its_gradient_match_jax(case):
    """The forward and the gradient of sum(y * r) with respect to x and the
    four weights, against jax.grad, f32, 2e-4 absolute."""
    shape, modes, tmodes = FILTER_CASES[case]
    C, nb = shape[-1], 2
    bs = C // nb
    x = rand(shape, 1)
    ws = [rand(s, 2 + i, 0.3) for i, s in enumerate(
        [(2, nb, bs, bs), (2, nb, bs), (2, nb, bs, bs), (2, nb, bs)])]
    r = rand(shape, 9)

    def jf(x, *w):
        y = jax_afno_filter_3d(x, *w, modes, tmodes, jax_activation("gelu"))
        return jnp.sum(y * r), y

    (_, jy), jg = jax.jit(jax.value_and_grad(jf, argnums=(0, 1, 2, 3, 4), has_aux=True))(
        jnp.asarray(x), *map(jnp.asarray, ws))
    tx = torch.from_numpy(x).requires_grad_()
    tw = [torch.from_numpy(w).requires_grad_() for w in ws]
    ty = afno_filter_3d(tx, *tw, modes, tmodes, get_activation("gelu"))
    (ty * torch.from_numpy(r)).sum().backward()
    assert ty.shape == shape and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=BAR, rtol=0)
    for t, j in zip([tx, *tw], jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=BAR, rtol=0)


def test_group_norm_at_rank_5_matches_jax():
    x = rand((2, 4, 4, 4, 16), 3, 2.0) + 1.0
    scale, bias = rand((16,), 4), rand((16,), 5)
    got = group_norm(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias), 8)
    want = jax_group_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("kw", [dict(normalize=False), dict(normalize=True),
                                dict(act="tanh", time_agg="mlp")],
                         ids=["plain", "normalize", "tanh_mlp"])
def test_forward_f32_matches_jax(kw):
    """Pred-only output of the reference shape. With act='tanh' both
    packages keep GELU in the 3D mode MLP (the reference's quirk) and tanh
    elsewhere; time_agg='mlp' drops the exp_mlp gamma."""
    tm = build_model("DPOT3D", device="cpu", seed=0, **CFG, **kw)
    jm = jax_build_model("DPOT3D", **CFG, **kw)
    x = 2.0 * rand((2, 16, 16, 16, 3, 2), 6) + 0.5
    with torch.no_grad():
        ty = tm(torch.from_numpy(x))
    jy = jm.apply(jax_params(tm, kw.get("normalize", False)), jnp.asarray(x))
    assert isinstance(ty, torch.Tensor) and ty.shape == (2, 16, 16, 16, 1, 2)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=BAR, rtol=0)


def test_forward_bf16_matches_jax_bf16():
    tm = build_model("DPOT3D", device="cpu", seed=1, dtype=torch.bfloat16, **CFG)
    jm = jax_build_model("DPOT3D", dtype=jnp.bfloat16, **CFG)
    x = rand((2, 16, 16, 16, 3, 2), 7)
    with torch.no_grad():
        ty = tm(torch.from_numpy(x)).numpy()
    jy = np.asarray(jm.apply(jax_params(tm), jnp.asarray(x)))
    assert ty.dtype == np.float32 and np.isfinite(ty).all()
    assert rel_l2(ty, jy) < 2e-2


def test_state_dict_from_jax_round_trips_the_3d_tree():
    """dpot3d_params_from_torch(state_dict_from_jax(p)) is p, leaf for leaf,
    with normalize on and off, and the state dict loads strict."""
    for normalize in (False, True):
        m = build_model("DPOT3D", normalize=normalize, device="cpu", seed=2, **CFG)
        p = jax_params(m, normalize)
        sd = state_dict_from_jax(p)
        back = dpot3d_params_from_torch({k: v.numpy() for k, v in sd.items()},
                                        depth=CFG["depth"], normalize=normalize)
        la, ta = jax.tree.flatten(p)
        lb, tb = jax.tree.flatten(back)
        assert ta == tb
        for a, b in zip(la, lb):
            np.testing.assert_array_equal(a, b)
        fresh = build_model("DPOT3D", normalize=normalize, device="cpu", seed=3, **CFG)
        fresh.load_state_dict(sd, strict=True)
        for k, v in m.state_dict().items():
            torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)


def test_jax_initialized_3d_params_serve_through_the_port():
    jm = jax_build_model("DPOT3D", **CFG)
    x = rand((1, 16, 16, 16, 3, 2), 8)
    p = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(x))
    tm = build_model("DPOT3D", device="cpu", **CFG)
    tm.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, p)), strict=True)
    with torch.no_grad():
        ty = tm(torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jm.apply(p, jnp.asarray(x))),
                               atol=BAR, rtol=0)


def test_remat_leaves_keys_outputs_and_gradients_unchanged():
    a = build_model("DPOT3D", device="cpu", seed=4, **CFG)
    b = build_model("DPOT3D", device="cpu", seed=4, remat=True, **CFG)
    assert list(a.state_dict()) == list(b.state_dict())
    x = torch.from_numpy(rand((1, 16, 16, 16, 3, 2), 9))
    ya, yb = a(x), b(x)
    torch.testing.assert_close(ya, yb, rtol=0, atol=0)
    ya.square().sum().backward()
    yb.square().sum().backward()
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        if pa.grad is None:
            assert pb.grad is None and name.startswith("cls_head"), name
            continue
        torch.testing.assert_close(pa.grad, pb.grad, rtol=1e-6, atol=1e-7)


def test_parameter_layout_is_the_reference_state_dict():
    m = build_model("DPOT3D", normalize=True, device="cpu", **CFG)
    shapes = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    E, D, p = 2 * 4 + 4, 32, 4
    assert shapes["patch_embed.proj.0.weight"] == (E, 2 + 4, p, p, p)
    assert shapes["patch_embed.proj.2.weight"] == (D, E, 1, 1, 1)
    assert shapes["pos_embed"] == (1, D, 4, 4, 4)
    assert shapes["time_agg_layer.w"] == (3, D, D)
    assert shapes["blocks.1.filter.w1"] == (2, 4, 8, 8)
    assert shapes["blocks.0.mlp.0.weight"] == (D, D, 1, 1, 1)
    assert shapes["out_layer.0.weight"] == (D, 32, p, p, p)
    assert shapes["out_layer.4.weight"] == (2, 32, 1, 1, 1)
    assert shapes["cls_head.4.weight"] == (1, D)
    assert shapes["scale_feats_mu.weight"] == (D, 4)


def jax_name(port_name: str) -> str:
    """The JAX leaf path of an inflated port entry."""
    if port_name.startswith("time_agg_layer."):
        return "time_agg/" + port_name.split(".", 1)[1]
    _, i, unit, *rest = port_name.split(".")
    leaf = {"weight": "scale", "bias": "bias"}
    if unit.startswith("norm"):
        return f"blocks_{i}/{unit}/{leaf[rest[0]]}"
    if unit == "filter":
        return f"blocks_{i}/filter/{rest[0]}"
    fc = {"0": "mlp_fc1", "2": "mlp_fc2"}[rest[0]]
    return f"blocks_{i}/{fc}/{'kernel' if rest[1] == 'weight' else 'bias'}"


@pytest.fixture(scope="module")
def inflation_pair():
    """A 2D model deeper than the 3D one (its extra block has nowhere to go)
    and with another T_in (its time_agg_layer.w does not fit; gamma does)."""
    m2 = build_model("DPOT", device="cpu", seed=5, **{**CFG, "depth": 3, "in_timesteps": 4,
                                                     "n_cls": 3})
    m3 = build_model("DPOT3D", device="cpu", seed=6, **CFG)
    return m2, m3


def test_inflation_copies_what_jax_copies(inflation_pair):
    """The copied entries, mapped to JAX's leaf names, and their count equal
    those of JAX's inflate_2d_to_3d on the same pair, and the merged state
    dict equals JAX's inflated tree in the port's layout."""
    m2, m3 = inflation_pair
    merged, copied = inflate_2d_to_3d(m3.state_dict(), m2.state_dict())
    p2 = dpot_params_from_torch({k: v.numpy() for k, v in m2.state_dict().items()}, depth=3)
    p3, jcopied = jax_inflate(jax_params(m3), p2)
    assert len(copied) == len(jcopied) == 12 * CFG["depth"] + 1
    assert sorted(jax_name(k) for k in copied) == sorted(jcopied)
    assert "time_agg_layer.w" not in copied and "blocks.0.mlp.0.weight" in copied
    want = state_dict_from_jax(jax.tree.map(np.asarray, p3))
    assert set(want) == set(merged)
    for k, v in merged.items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)


def test_inflated_models_agree_in_their_forward(inflation_pair):
    m2, m3 = inflation_pair
    merged, _ = inflate_2d_to_3d(m3.state_dict(), m2.state_dict())
    tm = build_model("DPOT3D", device="cpu", seed=7, **CFG)
    tm.load_state_dict(merged, strict=True)
    p2 = dpot_params_from_torch({k: v.numpy() for k, v in m2.state_dict().items()}, depth=3)
    p3, _ = jax_inflate(jax_params(m3), p2)
    x = rand((1, 16, 16, 16, 3, 2), 10)
    with torch.no_grad():
        ty = tm(torch.from_numpy(x))
    jy = jax_build_model("DPOT3D", **CFG).apply(p3, jnp.asarray(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=BAR, rtol=0)


def test_registry_builds_dpot3d_on_the_device_asked(monkeypatch):
    m = build_model("dpot3d", device="cpu", temporal_modes=3, **CFG)
    assert m.blocks[0].filter.temporal_modes == 3
    assert all(p.device.type == "cpu" for p in m.parameters())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model("DPOT3D", **CFG)
