"""The port's UNet (dpot_tpu_torch/models/unet.py) against the JAX package's
(dpot_tpu/models/unet.py) in train and eval mode, its BatchNorm statistics,
its reference-layout weights and the train loop's rollback of them.

Weights and running statistics are drawn by the port (moved off their init
by seeded noise) and carried into JAX by `unet_params_from_torch`. f32 at
2e-4 absolute (PARITY.md), bf16 at 2e-2 relative L2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpot_tpu.models import build_model as jax_build_model
from dpot_tpu.train.interop import unet_params_from_torch
from dpot_tpu_torch.models import build_model
from dpot_tpu_torch.train import loop
from dpot_tpu_torch.train.interop import params_from_any, state_dict_from_jax
from dpot_tpu_torch.train.optimizers import build_optimizer
from dpot_tpu_torch.train.state import TrainState
from dpot_tpu_torch.train.step import make_train_step

CFG = dict(img_size=12, in_channels=2, out_channels=2, in_timesteps=3, out_timesteps=1,
           out_layer_dim=4, n_cls=2)


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


def port_unet(seed=0, **kw):
    """A UNet whose weights and running statistics are all off their init."""
    model = build_model("UNet", device="cpu", seed=seed, **{**CFG, **kw})
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_var"):
                t.copy_(0.5 + torch.rand(t.shape, generator=g))
            elif t.is_floating_point():
                t.add_(0.1 * torch.randn(t.shape, generator=g))
    return model


def jax_variables(model):
    """JAX's variables of the model's state, copied (numpy would share the
    buffers' memory, which a train-mode forward then updates)."""
    return unet_params_from_torch({k: v.numpy().copy() for k, v in model.state_dict().items()})


def buffers(model):
    return {k: v.clone() for k, v in model.state_dict().items() if "running" in k}


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_jax(train):
    """Eval mode normalises with the running statistics; train mode with the
    batch's, and updates the statistics as JAX's mutable batch_stats (the
    12 x 12 grid is padded to 16 and cropped back)."""
    model = port_unet()
    jm = jax_build_model("UNet", **CFG)
    variables = jax_variables(model)
    x = 2.0 * rand((2, 12, 12, 3, 2)) + 0.5
    model.train(train)
    with torch.no_grad():
        ty, tc = model(torch.from_numpy(x))
    if train:
        (jy, jc), mut = jm.apply(variables, jnp.asarray(x), train=True,
                                 mutable=["batch_stats"])
        want = state_dict_from_jax({"params": variables["params"], **mut})
        for k, v in buffers(model).items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=2e-4, rtol=0,
                                       err_msg=k)
    else:
        jy, jc = jm.apply(variables, jnp.asarray(x))
    assert ty.shape == (2, 12, 12, 1, 2) and tc.shape == (2, 2) and not tc.any()
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=2e-4, rtol=0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=0, rtol=0)


def test_forward_bf16_matches_jax_bf16():
    model = port_unet(2, dtype=torch.bfloat16).eval()
    jm = jax_build_model("UNet", dtype=jnp.bfloat16, **CFG)
    x = rand((2, 12, 12, 3, 2), seed=3)
    with torch.no_grad():
        ty, _ = model(torch.from_numpy(x))
    jy, _ = jm.apply(jax_variables(model), jnp.asarray(x))
    assert rel_l2(ty.numpy(), np.asarray(jy)) <= 2e-2


def test_state_dict_from_jax_inverts_unet_params_from_torch(tmp_path):
    """params and batch_stats map to the parameters and running buffers
    (num_batches_tracked 0); a reference-layout .pth loads strictly."""
    model = port_unet(4)
    sd = model.state_dict()
    back = state_dict_from_jax(jax.device_get(jax_variables(model)))
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    path = tmp_path / "unet_ref.pth"
    torch.save({"args": None, "model": sd}, path)
    fresh = build_model("UNet", device="cpu", seed=5, **CFG)
    fresh.load_state_dict(params_from_any(str(path), fresh), strict=True)
    assert all(torch.equal(v, sd[k]) for k, v in fresh.state_dict().items())


def test_rollback_restores_the_running_statistics():
    """The loop's snapshot holds the BatchNorm buffers beside the weights
    and moments (JAX keeps them in its params), so a rollback undoes the
    statistics the exploded steps tracked."""
    model = port_unet(6)
    state = TrainState.create(model, build_optimizer("adam", model.parameters(), 1e-3), 0)
    rng = np.random.default_rng(7)
    batch = {"x": torch.from_numpy(rand((2, 12, 12, 3, 2), seed=8)),
             "y": torch.from_numpy(rand((2, 12, 12, 2, 2), seed=9)),
             "msk": torch.ones(2, 12, 12, 1, 2), "cls": torch.from_numpy(rng.integers(0, 2, 2))}
    step = make_train_step()
    snap = loop._snapshot(state)
    before = buffers(model)
    step(state, batch)
    assert not any(torch.equal(v, before[k]) for k, v in buffers(model).items())
    loop._restore(state, snap)
    for k, v in buffers(model).items():
        assert torch.equal(v, before[k]), k


def test_the_working_copy_refuses_batch_norm_statistics():
    model = port_unet(10)
    opt = build_optimizer("adam", model.parameters(), 1e-3)
    with pytest.raises(ValueError, match="buffers"):
        TrainState.create(model, opt, 0, param_working_dtype=torch.bfloat16)


@pytest.mark.parametrize("n_dim", [1, 3])
def test_the_other_ranks_match_jax(n_dim):
    """The dimension-generic UNet in 1D (a 20-point line, padded to 32) and
    3D (an 8^3 grid, padded to 16^3), eval mode; the registry builds 2D."""
    from dpot_tpu.models.unet import UNet as JaxUNet
    from dpot_tpu_torch.models.unet import UNet

    n = 20 if n_dim == 1 else 8
    model = UNet(in_channels=2, out_channels=2, width=2, n_dim=n_dim, in_timesteps=3,
                 device="cpu", seed=11).eval()
    x = rand((2, *(n,) * n_dim, 3, 2), seed=12)
    with torch.no_grad():
        got, _ = model(torch.from_numpy(x))
    want, _ = JaxUNet(in_channels=2, out_channels=2, width=2, n_dim=n_dim).apply(
        jax_variables(model), jnp.asarray(x))
    assert got.shape == (2, *(n,) * n_dim, 1, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)
