"""The port's CDPOTNet (dpot_tpu_torch/models/cdpot.py) against the JAX
package's (dpot_tpu/models/cdpot.py) on the same weights and inputs, and its
reference-layout weights.

Weights are drawn by the port from a seed, every one moved off its init by
seeded noise (so that the zero-initialised filter biases matter), and
carried into JAX by the JAX package's `cdpot_params_from_torch`. f32 at 2e-4
absolute (PARITY.md), bf16 at 2e-2 relative L2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpot_tpu.models import build_model as jax_build_model
from dpot_tpu.train.interop import cdpot_params_from_torch
from dpot_tpu_torch.models import build_model
from dpot_tpu_torch.train.interop import params_from_any, state_dict_from_jax

CFG = dict(img_size=16, patch_size=4, in_channels=2, out_channels=2, in_timesteps=4,
           out_timesteps=2, embed_dim=32, depth=2, n_blocks=4, modes=4, out_layer_dim=8,
           n_cls=3)


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


def port_model(seed=0, **kw):
    return perturbed(build_model("CDPOT", device="cpu", seed=seed, **{**CFG, **kw}), seed + 1)


def jax_params(model, normalize=False):
    sd = {k: v.detach().float().numpy() for k, v in model.state_dict().items()}
    return cdpot_params_from_torch(sd, depth=len(model.blocks), normalize=normalize)


def both(x, normalize=False, dtype=torch.float32, seed=0):
    tm = port_model(seed, normalize=normalize, dtype=dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jm = jax_build_model("CDPOT", normalize=normalize, dtype=jdt, **CFG)
    with torch.no_grad():
        ty, tc = tm(torch.from_numpy(x))
    jy, jc = jm.apply(jax_params(tm, normalize), jnp.asarray(x))
    return (ty.numpy(), tc.numpy()), (np.asarray(jy), np.asarray(jc))


@pytest.mark.parametrize("normalize", [False, True])
def test_forward_f32_matches_jax(normalize):
    x = 2.0 * rand((2, 16, 16, 4, 2)) + 1.0
    (ty, tc), (jy, jc) = both(x, normalize)
    assert ty.shape == jy.shape == (2, 16, 16, 2, 2) and tc.shape == (2, 3)
    np.testing.assert_allclose(ty, jy, atol=2e-4, rtol=0)
    np.testing.assert_allclose(tc, jc, atol=2e-4, rtol=0)


@pytest.mark.parametrize("normalize", [False, True])
def test_forward_bf16_matches_jax_bf16(normalize):
    """bf16 compute in both; the fused mixer, the f32 resampling rounded to
    bf16 and XLA's composed path round at different points."""
    x = rand((2, 16, 16, 4, 2), seed=2)
    (ty, tc), (jy, jc) = both(x, normalize, torch.bfloat16, seed=3)
    assert rel_l2(ty, jy) <= 2e-2 and rel_l2(tc, jc) <= 2e-2


def test_remat_leaves_keys_and_outputs_unchanged():
    a, b = port_model(4), port_model(4, remat=True)
    assert a.state_dict().keys() == b.state_dict().keys()
    x = torch.from_numpy(rand((2, 16, 16, 4, 2), seed=5))
    ya, ca = a(x)
    yb, cb = b(x)
    assert torch.equal(ya, yb) and torch.equal(ca, cb)
    (ya.square().sum() + ca.sum()).backward()
    (yb.square().sum() + cb.sum()).backward()
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        torch.testing.assert_close(q.grad, p.grad, rtol=1e-6, atol=1e-7, msg=n)


def test_state_dict_from_jax_inverts_cdpot_params_from_torch():
    model = port_model(6, normalize=True)
    sd = model.state_dict()
    back = state_dict_from_jax(jax.device_get(jax_params(model, normalize=True)))
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_reference_state_dict_with_both_duplicate_keys_loads_strictly(tmp_path):
    """The reference registers the patch embed's filtered activation twice
    (act_patching and proj.1), so its file holds both bias keys; the port's
    state dict has both, and they are one parameter."""
    model = port_model(8)
    sd = model.state_dict()
    assert torch.equal(sd["patch_embed.act_patching.bias"], sd["patch_embed.proj.1.bias"])
    names = [n for n, _ in model.named_parameters()]
    assert "patch_embed.act_patching.bias" in names and "patch_embed.proj.1.bias" not in names
    ref = {f"module.{k}": v.clone() for k, v in sd.items()}
    path = tmp_path / "cdpot_ref.pth"
    torch.save({"args": None, "model": ref}, path)
    fresh = build_model("CDPOT", device="cpu", seed=9, **CFG)
    fresh.load_state_dict(params_from_any(str(path), fresh), strict=True)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, sd[k]), k
    assert fresh.patch_embed.proj[1] is fresh.patch_embed.act_patching


def test_parameter_layout_is_the_reference_state_dict():
    sd = build_model("CDPOT", device="cpu", **CFG).state_dict()
    E = CFG["out_channels"] * CFG["patch_size"] + 3
    want = {
        "patch_embed.proj.0.weight": (E, 2 + 3, 4, 4),
        "patch_embed.proj.2.weight": (32, E, 1, 1),
        "patch_embed.act_patching.bias": (E,),
        "pos_embed": (1, 32, 4, 4),
        "out_layer.0.convolution.weight": (8, 32, 1, 1),
        "out_layer.0.activation.bias": (8,),
        "out_layer.1.weight": (8, 8, 1, 1),
        "out_layer.3.weight": (4, 8, 1, 1),
        "cls_head.4.weight": (3, 32),
        "blocks.1.filter.w1": (2, 4, 8, 8),
    }
    for k, shape in want.items():
        assert tuple(sd[k].shape) == shape, k


def test_cno_block_with_a_3x3_kernel_matches_jax():
    """CNOBlock beyond CDPOT's conv_kernel 1: the low-pass filter keeps the
    [:H//3, :H//3] corner, a 'same' 3x3 convolution, the filtered
    activation resampling 8 -> 16."""
    from dpot_tpu.models.cdpot import CNOBlock as JaxCNOBlock
    from dpot_tpu_torch.models.cdpot import CNOBlock

    block = CNOBlock(5, 4, 8, 16, 3, torch.float32, torch.Generator().manual_seed(0))
    perturbed(block)
    x = rand((2, 8, 8, 5), seed=9)
    params = {"params": {
        "convolution": {"kernel": block.convolution.weight.detach().permute(2, 3, 1, 0).numpy(),
                        "bias": block.convolution.bias.detach().numpy()},
        "act_bias": block.activation.bias.detach().numpy()}}
    want = JaxCNOBlock(out_channels=4, in_size=8, out_size=16, conv_kernel=3).apply(
        params, jnp.asarray(x))
    with torch.no_grad():
        got = block(torch.from_numpy(x))
    assert got.shape == (2, 16, 16, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)
