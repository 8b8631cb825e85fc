"""The bf16 working copy of the parameters in the port
(`TrainState.create(..., param_working_dtype=torch.bfloat16)`, JAX's
`TrainState.params_lp`): the JAX package's own tests of it
(tests/test_bf16_params.py) at their bars on the port, the port against
JAX with the copy on both sides, the loop's rollback, and the fused op
taking the copy's bf16 vectors and weights.

The forward and backward consume the bf16 copy; the optimizer keeps the
f32 master, upcasts the bf16 gradients and updates the master; the copy is
cast again from it after every update.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from dpot_tpu.models import build_model as jax_build_model
from dpot_tpu.train.interop import dpot_params_from_torch
from dpot_tpu.train.optimizers import build_optimizer as jax_build_optimizer
from dpot_tpu.train.state import TrainState as JaxTrainState
from dpot_tpu.train.step import make_train_step as jax_train_step
from dpot_tpu_torch.models import build_model
from dpot_tpu_torch.ops.cuda.afno_fused import fused_gn_afno
from dpot_tpu_torch.ops.spectral import combined_spectral_ops, kept_modes
from dpot_tpu_torch.train import loop
from dpot_tpu_torch.train.checkpoint import restore_checkpoint, restore_params, save_checkpoint
from dpot_tpu_torch.train.interop import state_dict_from_jax
from dpot_tpu_torch.train.optimizers import build_optimizer
from dpot_tpu_torch.train.state import TrainState
from dpot_tpu_torch.train.step import make_train_step

# the JAX tests' model: bf16 compute, embed 32 in 4 blocks, depth 2
TINY = dict(img_size=16, patch_size=4, in_channels=2, out_channels=2, in_timesteps=4,
            out_timesteps=1, embed_dim=32, depth=2, n_blocks=4, modes=8, n_cls=3)
BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_batch(B=4):
    """The JAX tests' batch: y the last input frame, an all-ones mask."""
    x = np.random.default_rng(0).standard_normal((B, 16, 16, 4, 2)).astype(np.float32)
    return dict(x=x, y=x[..., -1:, :].copy(), msk=np.ones((B, 16, 16, 1, 2), np.float32),
                cls=np.zeros(B, np.int32))


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.cache
def jax_init() -> dict:
    """The JAX tests' weights: their model initialised with key 0 on their
    batch. From the port's seeded weights Lamb at lr 1e-2 drifts apart by
    more than the 5 % bar within 10 steps in both packages, with the working
    copy and without (JAX 4.81 against 4.13 at step 5), so the port's runs
    start where the JAX tests start."""
    jm = jax_build_model("DPOT", dtype=jnp.bfloat16, **TINY)
    return jm.init(jax.random.key(0), jnp.asarray(tiny_batch()["x"]))


def make_state(lever: bool, opt: str = "lamb") -> TrainState:
    """The bf16-compute model at the JAX tests' weights and its state, lr
    1e-2 and clip 1 as in those tests, with or without the working copy."""
    model = build_model("DPOT", device="cpu", dtype=BF16, **TINY)
    model.load_state_dict(state_dict_from_jax(jax.device_get(jax_init())), strict=True)
    opt = build_optimizer(opt, model.parameters(), 1e-2, grad_clip=1.0)
    return TrainState.create(model, opt, 1, param_working_dtype=BF16 if lever else None)


def assert_exact_cast(state: TrainState) -> None:
    """The master is f32 and the model's parameters are its bf16 cast."""
    params = list(state.model.parameters())
    assert len(params) == len(state.optimizer.params) > 0
    for p, m in zip(params, state.optimizer.params):
        assert m.dtype == torch.float32 and p.dtype == BF16
        assert torch.equal(p, m.to(BF16))


def test_working_copy_stays_exact_cast_and_learns():
    state = make_state(lever=True, opt="adam")
    step = make_train_step()
    batch = to_torch(tiny_batch())
    losses = [step(state, batch)[1]["loss_step"].item() for _ in range(60)]
    assert_exact_cast(state)
    assert losses[-1] < losses[0] * 0.6, losses[::10]


def test_working_copy_tracks_f32_path():
    """Both runs compute in bf16; the A/B isolates the storage: the losses
    within 5 % of the f32-master run's for 10 steps."""
    s_ref, s_lp = make_state(lever=False), make_state(lever=True)
    step = make_train_step()
    batch = to_torch(tiny_batch())
    for i in range(10):
        a = step(s_ref, batch)[1]["loss_step"].item()
        b = step(s_lp, batch)[1]["loss_step"].item()
        assert abs(a - b) / a < 0.05, (i, a, b)


def test_working_copy_grad_accum_matches_full_batch(monkeypatch):
    """grad_accum=2 sums the microbatches' bf16 gradients in f32 and hands
    the optimizer the f32 sum: the loss of 3 steps within 2e-2 of the full
    batch's."""
    s1, s2 = make_state(lever=True), make_state(lever=True)
    handed = []
    real = s2.apply_gradients
    monkeypatch.setattr(s2, "apply_gradients",
                        lambda grads=None, values=None: handed.append(grads)
                        or real(grads, values))
    step_full, step_acc = make_train_step(), make_train_step(grad_accum=2)
    batch = to_torch(tiny_batch())
    for _ in range(3):
        a1 = step_full(s1, batch)[1]
        a2 = step_acc(s2, batch)[1]
    np.testing.assert_allclose(a2["loss_step"].item(), a1["loss_step"].item(), rtol=2e-2)
    assert len(handed) == 3
    assert all(g is None or g.dtype == torch.float32 for grads in handed for g in grads)
    assert_exact_cast(s2)


def test_working_copy_checkpoint_roundtrip(tmp_path):
    """The checkpoint holds the f32 master; a restore rebuilds the copy from
    it and training continues as the uninterrupted run (1e-6)."""
    state = make_state(lever=True)
    step = make_train_step()
    batch = to_torch(tiny_batch())
    for _ in range(3):
        step(state, batch)
    path = str(tmp_path / "ck")
    save_checkpoint(path, state)
    saved = restore_params(path)
    for (name, _), m in zip(state.model.named_parameters(), state.optimizer.params):
        assert saved[name].dtype == torch.float32 and torch.equal(saved[name], m), name
    restored = restore_checkpoint(path, make_state(lever=True))
    assert restored.step == 3
    assert_exact_cast(restored)
    for m, r in zip(state.optimizer.params, restored.optimizer.params):
        assert torch.equal(m, r)
    a = step(state, batch)[1]["loss_step"].item()
    b = step(restored, batch)[1]["loss_step"].item()
    np.testing.assert_allclose(b, a, rtol=1e-6)


def test_working_copy_matches_jax_working_copy():
    """The same weights with a bf16 working copy in both packages (bf16
    compute, Lamb), the port's seeded weights carried into JAX: three
    steps, each loss within 2e-2 relative."""
    model = build_model("DPOT", device="cpu", seed=4, dtype=BF16, **TINY)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    state = TrainState.create(model, build_optimizer("lamb", model.parameters(), 1e-2,
                                                     grad_clip=1.0), 1,
                              param_working_dtype=BF16)
    jm = jax_build_model("DPOT", dtype=jnp.bfloat16, **TINY)
    params = dpot_params_from_torch(sd, depth=TINY["depth"], normalize=False)
    jstate = JaxTrainState.create(jm.apply, params,
                                  jax_build_optimizer("lamb", 1e-2, grad_clip=1.0),
                                  jax.random.key(1), param_working_dtype=jnp.bfloat16)
    jstep = jax_train_step(t_bundle=1, noise_scale=0.0, donate=False)
    step = make_train_step()
    batch = tiny_batch()
    for i in range(3):
        jstate, jaux = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        want = float(jaux["loss_step"])
        got = step(state, to_torch(batch))[1]["loss_step"].item()
        assert abs(got - want) <= 2e-2 * abs(want), (i, got, want)


def test_rollback_restores_the_master_and_refreshes_the_copy():
    """The loop's rollback writes the snapshot into the f32 master and the
    moments, then casts the copy again: the next step is the step the
    snapshot's state takes, not one from stale bf16 weights."""
    state = make_state(lever=True)
    step = make_train_step()
    batch = to_torch(tiny_batch())
    step(state, batch)
    snap = loop._snapshot(state)
    want = step(state, batch)[1]["loss_step"].item()
    step(state, batch)
    loop._restore(state, snap)
    assert_exact_cast(state)
    for m, s in zip(state.optimizer.params, snap):
        assert torch.equal(m, s)
    assert step(state, batch)[1]["loss_step"].item() == want


def test_working_copy_refuses_what_it_cannot_hold():
    """A working dtype other than bf16, or an optimizer that does not update
    the model's own parameters, raises."""
    model = build_model("DPOT", device="cpu", **TINY)
    for dtype in (torch.float32, torch.float16):
        with pytest.raises(ValueError, match="is bfloat16"):
            TrainState.create(model, build_optimizer("adam", model.parameters(), 1e-3), 0,
                              param_working_dtype=dtype)
    other = build_model("DPOT", device="cpu", seed=1, **TINY)
    with pytest.raises(ValueError, match="the model's parameters"):
        TrainState.create(model, build_optimizer("adam", other.parameters(), 1e-3), 0,
                          param_working_dtype=BF16)


def afno_args(dtype, seed=0, B=2, H=8, W=8, C=96, nb=4, modes=3, groups=8):
    rng = np.random.default_rng(seed)
    bs = C // nb
    kh, kw = kept_modes(H, W, modes)

    def t(shape, scale=1.0, shift=0.0, dt=torch.float32):
        return torch.from_numpy((shift + scale * rng.standard_normal(shape))
                                .astype(np.float32)).to(dt)

    A, Ainv = combined_spectral_ops(H, W, kh, kw, dtype, torch.device("cpu"))
    return [t((B, H * W, C), dt=dtype), t((C,), 0.1, 1.0), t((C,), 0.1), A, Ainv,
            t((2, nb, bs, bs), 0.05), t((2, nb, bs), 0.05), t((2, nb, bs, bs), 0.05),
            t((2, nb, bs), 0.05)], kh * kw, groups


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_gn_afno_takes_the_working_copy(dtype):
    """gscale, gbias, w1, b1, w2 and b2 as bf16 tensors give exactly the f32
    call on the same values rounded to bf16 (the wrapper upcasts the
    vectors, the weights are rounded to the operand type where the kernels
    round them); their cotangents are the f32 call's rounded to bf16."""
    args, K, groups = afno_args(dtype)
    lp = [a.to(BF16) if i in (1, 2, 5, 6, 7, 8) else a for i, a in enumerate(args)]
    ref = [a.to(BF16).float() if i in (1, 2, 5, 6, 7, 8) else a for i, a in enumerate(args)]
    approx = dtype == torch.bfloat16
    leaves = (1, 2, 5, 6, 7, 8)
    for a in (lp, ref):
        for i in leaves:
            a[i].requires_grad_()
    got = fused_gn_afno(*lp, K, groups, approx)
    want = fused_gn_afno(*ref, K, groups, approx)
    assert torch.equal(got, want)
    g = torch.randn(got.shape, generator=torch.Generator().manual_seed(1)).to(dtype)
    gl = torch.autograd.grad(got, [lp[i] for i in leaves], g)
    gr = torch.autograd.grad(want, [ref[i] for i in leaves], g)
    for a, b in zip(gl, gr):
        assert a.dtype == BF16 and torch.equal(a, b.to(BF16))
