"""The port's MLP and FourierMLP (dpot_tpu_torch/models/mlp.py) against the
JAX package's (dpot_tpu/models/mlp.py) on the same weights (FourierMLP's
Gaussian frequencies carried across as its `constants`), f32 at 2e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpot_tpu.models.mlp import MLP as JaxMLP
from dpot_tpu.models.mlp import FourierMLP as JaxFourierMLP
from dpot_tpu.train.interop import mlp_params_from_torch
from dpot_tpu_torch.models.mlp import MLP, FourierMLP
from dpot_tpu_torch.train.interop import state_dict_from_jax


def rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def numpy_sd(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


@pytest.mark.parametrize("res", [True, False])
def test_mlp_matches_jax(res):
    model = MLP(3, 16, 2, n_layers=2, act="gelu", res=res, device="cpu", seed=0)
    p = mlp_params_from_torch(numpy_sd(model), n_layers=2)
    x = rand((5, 3))
    want = JaxMLP(16, 2, n_layers=2, act="gelu", res=res).apply(p, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)


def test_state_dict_from_jax_inverts_mlp_params_from_torch():
    model = MLP(3, 8, 2, n_layers=3, device="cpu", seed=1)
    back = state_dict_from_jax(mlp_params_from_torch(numpy_sd(model), n_layers=3))
    assert back.keys() == model.state_dict().keys()
    assert all(torch.equal(back[k], v) for k, v in model.state_dict().items())


def fourier_params(model: FourierMLP) -> dict:
    sd = numpy_sd(model)
    params = {"mlp": mlp_params_from_torch(
        {k[4:]: v for k, v in sd.items() if k.startswith("mlp.")},
        n_layers=len(model.mlp.linears))["params"]}
    if model.fourier_dim:
        params["theta_mlp"] = mlp_params_from_torch(
            {k[10:]: v for k, v in sd.items() if k.startswith("theta_mlp.")},
            n_layers=3)["params"]
    out = {"params": params}
    if "B" in sd:
        out["constants"] = {"B": sd["B"]}
    return out


@pytest.mark.parametrize("feature_type,fourier_dim", [("gaussian", 8), ("exp", 8),
                                                      ("gaussian", 0)])
def test_fourier_mlp_matches_jax(feature_type, fourier_dim):
    kw = dict(space_dim=2, theta_dim=1, output_size=3, n_layers=2, n_hidden=16,
              fourier_dim=fourier_dim, feature_type=feature_type, sigma=1.5)
    model = FourierMLP(**kw, device="cpu", seed=2)
    x, theta = rand((6, 2), seed=3), rand((6, 1), seed=4)
    want = JaxFourierMLP(**kw).apply(fourier_params(model), jnp.asarray(x), jnp.asarray(theta))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(theta))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)


def test_fourier_mlp_draws_its_frequencies_from_its_seed():
    a, b, c = (FourierMLP(fourier_dim=4, device="cpu", seed=s) for s in (0, 0, 1))
    assert torch.equal(a.B, b.B) and not torch.equal(a.B, c.B)
    assert a.B.shape == (2, 4) and "B" in a.state_dict()
    with torch.no_grad():
        assert a(torch.zeros(3, 2)).shape == (3, 3)
