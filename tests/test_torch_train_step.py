"""The port's train and eval steps (dpot_tpu_torch/train/step.py) against the
JAX package's, on a small DPOT in f32.

Weights are drawn by the port and carried into the JAX model by the JAX
package's `dpot_params_from_torch`; batches and the noise draws come from
numpy and go to both (the external-noise hook). The JAX f32 model takes its
rfft path, the port its combined DFT operators, so the bar is the interop
bar of PARITY.md: 2e-4.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from dpot_tpu.models import build_model as jax_build_model
from dpot_tpu.train.interop import dpot_params_from_torch
from dpot_tpu.train.optimizers import build_optimizer as jax_build_optimizer
from dpot_tpu.train.schedules import onecycle as jax_onecycle
from dpot_tpu.train.schedules import onecycle_momentum as jax_onecycle_momentum
from dpot_tpu.train.state import TrainState as JaxTrainState
from dpot_tpu.train.step import make_eval_rollout as jax_eval_rollout
from dpot_tpu.train.step import make_train_step as jax_train_step
from dpot_tpu_torch.models import build_model
from dpot_tpu_torch.train.interop import state_dict_from_jax
from dpot_tpu_torch.train.optimizers import build_optimizer
from dpot_tpu_torch.train.schedules import onecycle, onecycle_momentum
from dpot_tpu_torch.train.state import TrainState
from dpot_tpu_torch.train.step import make_eval_rollout, make_train_step

CFG = dict(img_size=16, patch_size=4, in_channels=2, out_channels=2, in_timesteps=4,
           out_timesteps=1, embed_dim=32, depth=2, n_blocks=4, modes=4, n_cls=2)
NOISE = 0.05
BAR = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def make_batch(seed, B=4, t_ar=2, noise_steps=2):
    """x, y, a mask that zeroes every other row of one sample, cls, and the
    standard-normal noise draws (n_steps, *x.shape). (A channel masked out
    whole would give NaN gradients in both packages: d sqrt(s)/ds at s = 0.)"""
    rng = np.random.default_rng(seed)
    f = np.float32
    msk = np.ones((B, 16, 16, 1, 2), f)
    msk[0, ::2] = 0.0
    return dict(
        x=(1.0 + rng.standard_normal((B, 16, 16, 4, 2))).astype(f),
        y=(1.0 + rng.standard_normal((B, 16, 16, t_ar, 2))).astype(f),
        msk=msk,
        cls=rng.integers(0, 2, B).astype(np.int32),
        noise=rng.standard_normal((noise_steps, B, 16, 16, 4, 2)).astype(f),
    )


def port_model(seed=0):
    return build_model("DPOT", device="cpu", seed=seed, **CFG)


def jax_params_of(model):
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    return dpot_params_from_torch(sd, depth=CFG["depth"], normalize=False)


def to_torch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def grab_grads():
    """An optax transform that leaves the params alone and keeps the last
    gradient tree as its state: the JAX step's exact gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g),
    )


def test_train_step_gradients_match_jax_grad():
    """One step, T_ar 2, noise 0.05 through the external draws, a masked
    loss: every parameter's gradient within 2e-4 rel-L2 of jax.grad (mapped
    to the port's layout by state_dict_from_jax); the cls head gets none in
    either package."""
    model = port_model()
    jm = jax_build_model("DPOT", **CFG)
    batch = make_batch(0)
    jstate = JaxTrainState.create(jm.apply, jax_params_of(model), grab_grads(),
                                  jax.random.key(0))
    jstate, jaux = jax_train_step(noise_scale=NOISE, donate=False)(jstate, to_jax(batch))
    want = state_dict_from_jax(jax.device_get(jstate.opt_state))

    state = TrainState.create(model, build_optimizer("adam", model.parameters(), 0.0), 0)
    state, aux = make_train_step(noise_scale=NOISE)(state, to_torch(batch))
    np.testing.assert_allclose(aux["loss_step"].item(), float(jaux["loss_step"]), rtol=1e-5)
    np.testing.assert_allclose(aux["loss_full"].item(), float(jaux["loss_full"]), rtol=1e-5)
    np.testing.assert_allclose(aux["cls_loss"].item(), float(jaux["cls_loss"]), rtol=1e-5)
    assert aux["cls_correct"].item() == float(jaux["cls_correct"])
    np.testing.assert_allclose(aux["grad_norm"].item(), float(jaux["grad_norm"]), rtol=BAR)
    for name, p in model.named_parameters():
        w = want[name].numpy()
        if name.startswith("cls_head"):
            assert p.grad is None and not w.any(), name
            continue
        assert rel_l2(p.grad.numpy(), w) <= BAR, (name, rel_l2(p.grad.numpy(), w))


@pytest.mark.parametrize("opt", ["adam", "lamb"])
def test_five_steps_match_jax(opt):
    """Five steps on five batches with a OneCycle lr and cycled beta1: the
    per-step loss within 1e-4 relative, the final params within 2e-4 rel-L2
    per tensor."""
    model = port_model(seed=1)
    jm = jax_build_model("DPOT", **CFG)
    kw = dict(beta2=0.9, grad_clip=1.0)
    tx = jax_build_optimizer(opt, jax_onecycle(3e-3, 5, 1, 3), jax_onecycle_momentum(5, 1, 3), **kw)
    jstate = JaxTrainState.create(jm.apply, jax_params_of(model), tx, jax.random.key(0))
    state = TrainState.create(model, build_optimizer(
        opt, model.parameters(), onecycle(3e-3, 5, 1, 3), onecycle_momentum(5, 1, 3), **kw), 0)
    jstep = jax_train_step(noise_scale=NOISE, donate=False)
    step = make_train_step(noise_scale=NOISE)
    for i in range(5):
        batch = make_batch(10 + i)
        jstate, jaux = jstep(jstate, to_jax(batch))
        state, aux = step(state, to_torch(batch))
        np.testing.assert_allclose(aux["loss_step"].item(), float(jaux["loss_step"]),
                                   rtol=1e-4)
    assert state.step == 5 == int(jstate.step)
    want = state_dict_from_jax(jax.device_get(jstate.params))
    for name, p in model.named_parameters():
        assert rel_l2(p.detach().numpy(), want[name].numpy()) <= BAR, name


def test_eval_rollout_matches_jax():
    """t_test 3 from a 4-frame input, masked: summed step loss, full loss and
    the prediction within 2e-4."""
    model = port_model(seed=2)
    jm = jax_build_model("DPOT", **CFG)
    b = make_batch(20, t_ar=3)
    del b["noise"], b["cls"]
    want = jax_eval_rollout(t_bundle=1)(jm.apply, jax_params_of(model), to_jax(b))
    got = make_eval_rollout(t_bundle=1)(model, to_torch(b))
    assert got["pred"].shape == (4, 16, 16, 3, 2)
    np.testing.assert_allclose(got["pred"].numpy(), np.asarray(want["pred"]), atol=BAR, rtol=0)
    for k in ("loss_step", "loss_full"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=BAR)


def _fresh(seed=3):
    model = port_model(seed=seed)
    return TrainState.create(model, build_optimizer("adam", model.parameters(), 1e-3), 0)


def test_grad_accum_gives_the_full_batch_update():
    """grad_accum=2 sums two microbatch gradients before one update: the same
    update as grad_accum=1 up to f32 summation order (1e-5 rel-L2)."""
    batch = make_batch(30)
    del batch["noise"]
    a, _ = make_train_step(grad_accum=1)(_fresh(), to_torch(batch))
    b, aux = make_train_step(grad_accum=2)(_fresh(), to_torch(batch))
    assert aux["n_steps"].item() == 2
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert rel_l2(q.detach().numpy(), p.detach().numpy()) <= 1e-5, n


def test_ones_mask_and_time_major_give_the_same_step():
    """An all-ones mask left out (ones_mask) and time-major x/y give the same
    update as the standard masked step."""
    batch = make_batch(31)
    del batch["noise"]
    batch["msk"][:] = 1.0
    ref, _ = make_train_step()(_fresh(), to_torch(batch))
    no_msk = {k: v for k, v in batch.items() if k != "msk"}
    om, _ = make_train_step(ones_mask=True)(_fresh(), to_torch(no_msk))
    tm_batch = dict(batch, x=np.moveaxis(batch["x"], -2, 1).copy(),
                    y=np.moveaxis(batch["y"], -2, 1).copy())
    tm, _ = make_train_step(time_major=True)(_fresh(), to_torch(tm_batch))
    for p, q, r in zip(ref.model.parameters(), om.model.parameters(), tm.model.parameters()):
        torch.testing.assert_close(q, p, rtol=0, atol=0)
        torch.testing.assert_close(r, p, rtol=0, atol=0)


def test_train_step_after_an_inference_rollout():
    """A served or evaluated model trains afterwards in the same process: the
    DFT operators and grid patches that an inference-mode forward cached are
    ordinary tensors, which the train step's backward may save."""
    from dpot_tpu_torch.models.dpot import grid_patches
    from dpot_tpu_torch.ops.spectral import combined_spectral_ops

    combined_spectral_ops.cache_clear()
    grid_patches.cache_clear()
    batch = make_batch(33)
    state = _fresh()
    make_eval_rollout()(state.model, to_torch(dict(batch, y=batch["y"][..., :1, :])))
    state, aux = make_train_step(noise_scale=NOISE)(state, to_torch(batch))
    assert np.isfinite(aux["loss_step"].item())
    assert all(p.grad is not None for n, p in state.model.named_parameters()
               if not n.startswith("cls_head"))


def test_generator_noise_is_reproducible():
    """Without external draws the noise comes from the state's generator: two
    states with the same seed take the same step."""
    batch = make_batch(32)
    del batch["noise"]
    a, ax = make_train_step(noise_scale=NOISE)(_fresh(), to_torch(batch))
    b, bx = make_train_step(noise_scale=NOISE)(_fresh(), to_torch(batch))
    assert ax["loss_step"].item() == bx["loss_step"].item()
