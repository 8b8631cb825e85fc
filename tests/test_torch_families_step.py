"""One train step and one eval rollout of CDPOT, FNO2d, FNO3d and UNet in the
port (dpot_tpu_torch/train/step.py) against the JAX package's
`make_train_step` / `make_eval_rollout`, on the same weights, batch and
noise draws (the external-noise hook), in f32.

The port's weights (moved off their init by seeded noise, UNet's running
statistics too) reach JAX through the JAX package's converters; the JAX
step's exact gradients are kept by an optax transform that updates
nothing. Limits: the losses within 1e-5 relative, every gradient within
1e-4 relative L2, the rollout's prediction within 2e-4 absolute; UNet's
running statistics after the step (two rollout steps, each updating them)
within 2e-4 of JAX's `batch_stats`. FNO3d is pred-only on both sides
(`pred_and_cls`, JAX's `wrap_pred_only`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dpot_tpu.models import build_model as jax_build_model
from dpot_tpu.train import interop as jax_interop
from dpot_tpu.train.state import TrainState as JaxTrainState
from dpot_tpu.train.step import make_eval_rollout as jax_eval_rollout
from dpot_tpu.train.step import make_train_step as jax_train_step
from dpot_tpu.train.step import wrap_pred_only
from dpot_tpu_torch.models import build_model
from dpot_tpu_torch.train.interop import state_dict_from_jax
from dpot_tpu_torch.train.optimizers import build_optimizer
from dpot_tpu_torch.train.state import TrainState
from dpot_tpu_torch.train.step import make_eval_rollout, make_train_step

NOISE = 0.05
LOSS_TOL, GRAD_TOL, PRED_TOL = 1e-5, 1e-4, 2e-4
FAMILIES = {
    "CDPOT": (dict(img_size=16, patch_size=4, in_channels=2, out_channels=2,
                   in_timesteps=4, out_timesteps=1, embed_dim=32, depth=2, n_blocks=4,
                   modes=4, out_layer_dim=8, n_cls=2), (16, 16)),
    "FNO": (dict(img_size=16, patch_size=1, in_channels=2, in_timesteps=4, embed_dim=16,
                 depth=2, modes=4, n_cls=2), (16, 16)),
    "FNO3D": (dict(img_size=8, in_channels=2, in_timesteps=4, embed_dim=8, depth=2,
                   modes=2), (8, 8, 8)),
    "UNet": (dict(img_size=16, in_channels=2, out_channels=2, in_timesteps=4,
                  out_layer_dim=4, n_cls=2), (16, 16)),
}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def port_model(family, seed=0):
    cfg, _ = FAMILIES[family]
    model = build_model(family, device="cpu", seed=seed, **cfg)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_var"):
                t.copy_(0.5 + torch.rand(t.shape, generator=g))
            elif t.is_floating_point():
                t.add_(0.05 * torch.randn(t.shape, generator=g))
    return model


def jax_side(family, model):
    """(JAX model, its apply for the steps, the variables of the port's
    weights)."""
    cfg, _ = FAMILIES[family]
    sd = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    if family == "CDPOT":
        variables = jax_interop.cdpot_params_from_torch(sd, depth=cfg["depth"])
    elif family == "FNO":
        variables = jax_interop.fno2d_params_from_torch(sd, n_layers=cfg["depth"])
    elif family == "FNO3D":
        sd = {k: (v[0] + 1j * v[1]).astype(np.complex64) if ".weights" in k else v
              for k, v in sd.items()}
        variables = jax_interop.fno3d_params_from_torch(sd, n_layers=cfg["depth"])
    else:
        variables = jax_interop.unet_params_from_torch(sd)
    jm = jax_build_model(family, **cfg)
    apply = wrap_pred_only(jm.apply) if family == "FNO3D" else jm.apply
    return jm, apply, variables


def make_batch(family, seed, t_ar=2, noise_steps=2, B=3):
    grid = FAMILIES[family][1]
    rng = np.random.default_rng(seed)
    f = np.float32
    msk = np.ones((B, *grid, 1, 2), f)
    msk[0, ::2] = 0.0
    return dict(
        x=(1.0 + rng.standard_normal((B, *grid, 4, 2))).astype(f),
        y=(1.0 + rng.standard_normal((B, *grid, t_ar, 2))).astype(f),
        # a pred-only model's one zero logit: class 0, as a 3D set's samples
        msk=msk, cls=rng.integers(0, 1 if len(grid) == 3 else 2, B).astype(np.int32),
        noise=rng.standard_normal((noise_steps, B, *grid, 4, 2)).astype(f),
    )


def grab_grads():
    """Leaves the params alone and keeps the last gradient tree as its
    state: the JAX step's exact gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g),
    )


@pytest.mark.parametrize("family", list(FAMILIES))
def test_train_step_matches_jax(family):
    model = port_model(family)
    _, apply, variables = jax_side(family, model)
    batch = make_batch(family, seed=1)
    jstate = JaxTrainState.create(apply, variables, grab_grads(), jax.random.key(0))
    jstate, jaux = jax_train_step(noise_scale=NOISE, donate=False)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    opt_state = jax.device_get(jstate.opt_state)
    if family == "UNet":  # the batch statistics are masked out of the optimizer
        jgrads = dict(opt_state.inner_state["params"])
        want = state_dict_from_jax({"params": jgrads,
                                    "batch_stats": jax.device_get(jstate.params)["batch_stats"]})
    else:
        want = state_dict_from_jax(opt_state)

    state = TrainState.create(model, build_optimizer("adam", model.parameters(), 0.0), 0)
    state, aux = make_train_step(noise_scale=NOISE)(
        state, {k: torch.from_numpy(v.copy()) for k, v in batch.items()})
    for k in ("loss_step", "loss_full", "cls_loss"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=LOSS_TOL, err_msg=k)
    assert aux["cls_correct"].item() == float(jaux["cls_correct"])
    np.testing.assert_allclose(aux["grad_norm"].item(), float(jaux["grad_norm"]), rtol=GRAD_TOL)
    for name, p in model.named_parameters():
        w = want[name].numpy()
        if p.grad is None:  # the cls head: not trained, zero in JAX
            assert name.startswith("cls_head") and not w.any(), name
            continue
        assert rel_l2(p.grad.numpy(), w) <= GRAD_TOL, (name, rel_l2(p.grad.numpy(), w))
    if family == "UNet":
        for name, b in model.named_buffers():
            if "running" in name:
                np.testing.assert_allclose(b.numpy(), want[name].numpy(), atol=PRED_TOL,
                                           rtol=0, err_msg=name)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_eval_rollout_matches_jax(family):
    """t_test 3 from a 4-frame input, masked; UNet in eval mode, on its
    running statistics."""
    model = port_model(family, seed=2)
    _, apply, variables = jax_side(family, model)
    b = make_batch(family, seed=3, t_ar=3)
    del b["noise"], b["cls"]
    want = jax_eval_rollout(t_bundle=1)(apply, variables, {k: jnp.asarray(v) for k, v in b.items()})
    got = make_eval_rollout(t_bundle=1)(model, {k: torch.from_numpy(v) for k, v in b.items()})
    assert got["pred"].shape == b["y"].shape and not model.training
    np.testing.assert_allclose(got["pred"].numpy(), np.asarray(want["pred"]), atol=PRED_TOL,
                               rtol=0)
    for k in ("loss_step", "loss_full"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=PRED_TOL)
