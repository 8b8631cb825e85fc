"""The separable route of the port's 2D mixer, for latents above 4096 px
(ops/spectral.py `afno_filter_2d`'s FFT branch and `separable_gn_afno`,
models/dpot.py AFNO2D's routing), against the JAX package's separable
branch of `afno_filter_2d` and its 2D model at such a latent, on the CPU.

f32 is held at the interop bar of PARITY.md, 2e-4 absolute (a train step's
loss at 1e-5 and every gradient at 1e-4 relative L2, as
tests/test_torch_train_step.py holds them); bf16 at 2e-2 relative L2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dpot_tpu.models import build_model as jax_build_model
from dpot_tpu.ops.activations import get_activation as jax_activation
from dpot_tpu.ops.spectral import afno_filter_2d as jax_afno_filter_2d
from dpot_tpu.train.interop import dpot_params_from_torch
from dpot_tpu.train.state import TrainState as JaxTrainState
from dpot_tpu.train.step import make_train_step as jax_train_step
from dpot_tpu_torch.models import build_model
from dpot_tpu_torch.ops.activations import get_activation
from dpot_tpu_torch.ops.cuda.afno_fused import fused_gn_afno
from dpot_tpu_torch.ops.spectral import afno_filter_2d, separable_gn_afno
from dpot_tpu_torch.train.interop import state_dict_from_jax
from dpot_tpu_torch.train.optimizers import build_optimizer
from dpot_tpu_torch.train.state import TrainState
from dpot_tpu_torch.train.step import make_train_step

BAR = 2e-4
# a 68 x 68 = 4624 px latent (patch 1), above the combined operators' 4096
CFG = dict(img_size=68, patch_size=1, in_channels=2, out_channels=2, in_timesteps=2,
           out_timesteps=1, embed_dim=16, depth=2, n_blocks=2, modes=4, n_cls=2)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def rand(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def filter_inputs(shape, seed):
    C, nb = shape[-1], 2
    bs = C // nb
    ws = [np.abs(rand(s, seed + i, 0.3)) for i, s in enumerate(
        [(2, nb, bs, bs), (2, nb, bs), (2, nb, bs, bs), (2, nb, bs)])]
    return rand(shape, seed), ws


# (B, H, W, C), modes: (1, 80, 72, 8) keeps an 8 x 8 corner; at (2, 65, 64, 8)
# modes 40 exceed the halved last axis (kw = 33)
@pytest.mark.parametrize("shape,modes", [((1, 80, 72, 8), 8), ((2, 65, 64, 8), 40)])
def test_separable_filter_and_its_gradient_match_jax(shape, modes):
    x, ws = filter_inputs(shape, 1)
    r = rand(shape, 9)

    def jf(x, *w):
        y = jax_afno_filter_2d(x, *w, modes, jax_activation("gelu"))
        return jnp.sum(y * r), y

    (_, jy), jg = jax.jit(jax.value_and_grad(jf, argnums=(0, 1, 2, 3, 4), has_aux=True))(
        jnp.asarray(x), *map(jnp.asarray, ws))
    tx = torch.from_numpy(x).requires_grad_()
    tw = [torch.from_numpy(w).requires_grad_() for w in ws]
    ty = afno_filter_2d(tx, *tw, modes, get_activation("gelu"))
    (ty * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=BAR, rtol=0)
    for t, j in zip([tx, *tw], jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=BAR, rtol=0)


def test_separable_filter_bf16_matches_jax_bf16():
    """x and the mode MLP in bf16, the FFTs in f32 (both packages)."""
    x, ws = filter_inputs((1, 80, 72, 8), 2)
    jy = jax_afno_filter_2d(jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, ws), 8,
                            jax_activation("gelu"), compute_dtype=jnp.bfloat16)
    ty = afno_filter_2d(torch.from_numpy(x).bfloat16(), *map(torch.from_numpy, ws), 8,
                        get_activation("gelu"), torch.bfloat16)
    assert ty.dtype == torch.bfloat16
    assert rel_l2(ty.float().numpy(), np.asarray(jy.astype(jnp.float32))) < 2e-2


def jax_params_of(model):
    sd = {k: v.detach().float().numpy() for k, v in model.state_dict().items()}
    return dpot_params_from_torch(sd, depth=CFG["depth"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_above_4096_px_matches_jax(dtype):
    """The 2D model at a 4624-px latent: norm1 then the separable branch in
    both packages (the fused op takes no such latent)."""
    tm = build_model("DPOT", device="cpu", seed=0, dtype=getattr(torch, dtype), **CFG)
    jm = jax_build_model("DPOT", dtype=getattr(jnp, dtype), **CFG)
    x = rand((2, 68, 68, 2, 2), 3) + 1.0
    with torch.no_grad():
        ty, tc = tm(torch.from_numpy(x))
    jy, jc = jm.apply(jax_params_of(tm), jnp.asarray(x))
    assert ty.shape == (2, 68, 68, 1, 2) and np.isfinite(ty.numpy()).all()
    if dtype == "float32":
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=BAR, rtol=0)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=BAR, rtol=0)
    else:
        assert rel_l2(ty.numpy(), jy) < 2e-2


def grab_grads():
    """An optax transform that keeps the last gradient tree as its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g),
    )


def test_train_step_above_4096_px_matches_jax():
    """One step, T_ar 2 and noise through the external draws: the loss
    within 1e-5 and every gradient within 1e-4 relative L2 of jax.grad."""
    rng = np.random.default_rng(4)
    f = np.float32
    batch = dict(x=(1.0 + rng.standard_normal((2, 68, 68, 2, 2))).astype(f),
                 y=(1.0 + rng.standard_normal((2, 68, 68, 2, 2))).astype(f),
                 msk=np.ones((2, 68, 68, 1, 2), f), cls=np.array([0, 1], np.int32),
                 noise=rng.standard_normal((2, 2, 68, 68, 2, 2)).astype(f))
    model = build_model("DPOT", device="cpu", seed=1, **CFG)
    jm = jax_build_model("DPOT", **CFG)
    jstate = JaxTrainState.create(jm.apply, jax_params_of(model), grab_grads(),
                                  jax.random.key(0))
    jstate, jaux = jax_train_step(noise_scale=0.05, donate=False)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    want = state_dict_from_jax(jax.device_get(jstate.opt_state))
    state = TrainState.create(model, build_optimizer("adam", model.parameters(), 0.0), 0)
    state, aux = make_train_step(noise_scale=0.05)(
        state, {k: torch.from_numpy(v.copy()) for k, v in batch.items()})
    np.testing.assert_allclose(aux["loss_step"].item(), float(jaux["loss_step"]), rtol=1e-5)
    for name, p in model.named_parameters():
        if name.startswith("cls_head"):
            continue
        assert rel_l2(p.grad.numpy(), want[name].numpy()) <= 1e-4, name


def test_the_route_follows_the_latent_and_counts_its_calls():
    """Above 4096 px every block takes the separable route once an
    application (depth calls), the fused op never; at 4096 px and below the
    route is never taken."""
    big = build_model("DPOT", device="cpu", seed=2, **CFG)
    small = build_model("DPOT", device="cpu", seed=2, **{**CFG, "img_size": 64})
    before, launches = separable_gn_afno.calls, fused_gn_afno.launches
    with torch.no_grad():
        big(torch.zeros(1, 68, 68, 2, 2))
        big(torch.zeros(1, 68, 68, 2, 2))
    assert separable_gn_afno.calls - before == 2 * CFG["depth"]
    with torch.no_grad():
        small(torch.zeros(1, 64, 64, 2, 2))
    assert separable_gn_afno.calls - before == 2 * CFG["depth"]
    assert fused_gn_afno.launches == launches


def test_the_fused_op_refuses_latents_above_4096_px_naming_the_separable_route():
    x = torch.zeros(1, 4624, 8)
    w, b = torch.zeros(2, 2, 4, 4), torch.zeros(2, 2, 4)
    g = torch.ones(8)
    with pytest.raises(ValueError, match="separable"):
        fused_gn_afno(x, g, g, torch.zeros(32, 4624), torch.zeros(4624, 32), w, b, w, b,
                      16, 2)
    with pytest.raises(ValueError, match="fused route"):
        separable_gn_afno(torch.zeros(1, 64, 64, 8), g, g, 2, w, b, w, b, 4, torch.tanh)


def test_server_answers_a_model_above_4096_px():
    """RolloutServer serving a 2D DPOT on the separable route (a 68 x 68
    latent): every answer (batch 1 and a padded 3 of bucket 4, 1 and 2
    steps) equals a direct loop over model(x); the route's calls are depth
    x the applications run, warm-up included."""
    from dpot_tpu_torch.serve import RolloutServer

    model = build_model("DPOT", device="cpu", seed=3, **CFG)
    before = separable_gn_afno.calls
    rs = RolloutServer(model, batch_buckets=(1, 4), max_wait_ms=0.0, device="cpu")
    rs.start()
    apps = 1  # start() warms the largest bucket up with one step
    try:
        for b, steps in ((1, 1), (3, 2)):
            x = rand((b, 68, 68, 2, 2), seed=10 + b)
            got = rs.submit(x, steps)
            apps += steps
            carry, want = torch.from_numpy(x), []
            with torch.inference_mode():
                for _ in range(steps):
                    im = model(carry)[0]
                    want.append(im)
                    carry = torch.cat([carry[..., 1:, :], im], dim=-2)
            np.testing.assert_array_equal(got, torch.cat(want, dim=-2).numpy())
    finally:
        rs.stop(drain=True)
    direct = 1 + 2
    assert separable_gn_afno.calls - before == CFG["depth"] * (apps + direct)
