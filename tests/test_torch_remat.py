"""Activation recomputation in the port (`remat`: dpot_tpu_torch/models/dpot.py
under torch.utils.checkpoint, passed through models/registry.py and the
train loop) against the same step without it and against the JAX package's
`DPOTNet(remat=True)` (`nn.remat(Block)`), on the CPU at a small size with
DPOT-L's block layout: 16 AFNO blocks under GroupNorm(8), so that each
group spans two blocks.

Weights are drawn by the port and carried into the JAX model by
`dpot_params_from_torch`; batches and noise draws come from numpy (the
external-noise hook). Bars: remat against no remat, 1e-7 relative L2 (the
same ops on the same inputs: expected bitwise); against JAX, f32 gradients
2e-4 (PARITY.md's interop bar) and the bf16 loss 2e-2 (the bf16 model bar).
"""

import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from dpot_tpu.models import build_model as jax_build_model
from dpot_tpu.train.interop import dpot_params_from_torch
from dpot_tpu.train.state import TrainState as JaxTrainState
from dpot_tpu.train.step import make_train_step as jax_train_step
from dpot_tpu_torch.cli import finetune, train
from dpot_tpu_torch.data.registry import make_synthetic_spec
from dpot_tpu_torch.models import build_model
from dpot_tpu_torch.models import dpot as port_dpot
from dpot_tpu_torch.train.interop import state_dict_from_jax
from dpot_tpu_torch.train.optimizers import build_optimizer
from dpot_tpu_torch.train.state import TrainState
from dpot_tpu_torch.train.step import make_train_step

# L's layout in miniature: embed 192 in 16 blocks of 12 channels, GroupNorm(8)
# groups of 24 channels (two blocks each), depth 3
L_LAYOUT = dict(img_size=16, patch_size=4, in_channels=2, out_channels=2, in_timesteps=4,
                out_timesteps=1, embed_dim=192, depth=3, n_blocks=16, modes=4, n_cls=2)
NOISE = 0.05
EQUAL = 1e-7
BAR = {"float32": 2e-4, "bfloat16": 2e-2}
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    make_synthetic_spec("synthetic_remat", train_size=2, test_size=2, t_total=8, t_test=2,
                        in_size=(16, 16), n_channels=2)
    yield
    torch.set_num_threads(n)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def make_batch(seed, B=2, t_ar=2):
    """x, y, a mask that zeroes every other row of one sample, cls and the
    noise draws (t_ar, *x.shape)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    msk = np.ones((B, 16, 16, 1, 2), f)
    msk[0, ::2] = 0.0
    return dict(
        x=(1.0 + rng.standard_normal((B, 16, 16, 4, 2))).astype(f),
        y=(1.0 + rng.standard_normal((B, 16, 16, t_ar, 2))).astype(f),
        msk=msk, cls=rng.integers(0, 2, B).astype(np.int32),
        noise=rng.standard_normal((t_ar, B, 16, 16, 4, 2)).astype(f),
    )


def to_torch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def port_step(remat, dtype="float32", seed=0, batch_seed=0):
    """One step of a seeded port model with lr 0 (the weights stay): the
    loss and every parameter's gradient."""
    model = build_model("DPOT", device="cpu", seed=seed, remat=remat,
                        dtype=DTYPES[dtype][0], **L_LAYOUT)
    state = TrainState.create(model, build_optimizer("lamb", model.parameters(), 0.0), 0)
    _, aux = make_train_step(noise_scale=NOISE)(state, to_torch(make_batch(batch_seed)))
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    return model, aux["loss_step"].item(), grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_step_equals_the_step_without_it(dtype):
    """The recomputation runs the same ops on the same inputs: the loss and
    every gradient as without remat (expected bitwise; at most 1e-7)."""
    _, loss0, g0 = port_step(False, dtype)
    _, loss1, g1 = port_step(True, dtype)
    assert abs(loss1 - loss0) <= EQUAL * abs(loss0)
    assert g0.keys() == g1.keys() and len(g0) > 0
    for name in g0:
        assert rel_l2(g1[name].float(), g0[name].float()) <= EQUAL, name


def grab_grads():
    """An optax transform that leaves the params alone and keeps the last
    gradient tree as its state: the JAX step's exact gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g),
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_step_matches_jax_remat(dtype):
    """One step with remat in both packages on the same weights, batch and
    noise: f32 loss within 1e-5 and every gradient within 2e-4 relative L2;
    bf16 loss within 2e-2 (the packages round at different points)."""
    model, loss, grads = port_step(True, dtype, seed=1, batch_seed=3)
    jm = jax_build_model("DPOT", remat=True, dtype=DTYPES[dtype][1], **L_LAYOUT)
    sd = {k: v.detach().float().numpy() for k, v in model.state_dict().items()}
    params = dpot_params_from_torch(sd, depth=L_LAYOUT["depth"], normalize=False)
    jstate = JaxTrainState.create(jm.apply, params, grab_grads(), jax.random.key(0))
    batch = {k: jnp.asarray(v) for k, v in make_batch(3).items()}
    jstate, jaux = jax_train_step(noise_scale=NOISE, donate=False)(jstate, batch)
    jloss = float(jaux["loss_step"])
    if dtype == "bfloat16":
        assert abs(loss - jloss) <= BAR[dtype] * abs(jloss)
        return
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    want = state_dict_from_jax(jax.device_get(jstate.opt_state))
    for name, _ in model.named_parameters():
        w = want[name].numpy()
        if name.startswith("cls_head"):
            assert name not in grads and not w.any(), name
            continue
        assert rel_l2(grads[name], w) <= BAR[dtype], (name, rel_l2(grads[name], w))


def test_remat_keeps_the_state_dict_keys_and_checkpoints_only_under_grad(monkeypatch):
    """The blocks are not wrapped, so the keys stay `blocks.{i}.…` (the
    layout interop and the released .pth files use); a forward under grad
    mode runs each block through checkpoint, one without grad does not."""
    plain = build_model("DPOT", device="cpu", seed=2, **L_LAYOUT)
    remat = build_model("DPOT", device="cpu", seed=2, remat=True, **L_LAYOUT)
    assert list(remat.state_dict()) == list(plain.state_dict())
    assert "blocks.2.filter.w1" in remat.state_dict()
    calls = []
    real = port_dpot.checkpoint
    monkeypatch.setattr(port_dpot, "checkpoint",
                        lambda fn, *a, **k: calls.append(fn) or real(fn, *a, **k))
    x = torch.from_numpy(make_batch(4)["x"])
    with torch.no_grad():
        want = plain(x)[0]
        got = remat(x)[0]
    assert calls == [] and torch.equal(got, want)
    remat(x)[0].sum().backward()
    assert calls == list(remat.blocks)


TINY = ["--model", "DPOT", "--train_paths", "synthetic_remat", "--res", "16",
        "--patch_size", "4", "--width", "192", "--n_layers", "2", "--n_blocks", "16",
        "--modes", "4", "--T_in", "4", "--batch_size", "8", "--num_workers", "1",
        "--lr", "1e-3", "--warmup_epochs", "1", "--epochs", "2", "--noise_scale", "0.01",
        "--opt", "lamb", "--use_writer", "true", "--device", "cpu"]


def losses(out):
    with open(f"{out['log_dir']}/metrics.jsonl") as f:
        return [r["value"] for r in map(json.loads, f) if r["tag"] == "train_loss_step"]


@pytest.mark.parametrize("cli", ["train", "finetune"])
def test_cli_with_remat_matches_the_run_without_it(cli, tmp_path):
    """`cli.train --remat true` and `cli.finetune --remat true` (which trains
    through the same loop) take the same steps as without remat: the model
    has remat on, and the losses and final weights are the same (1e-7)."""
    main = {"train": train.main, "finetune": finetune.main}[cli]
    outs = [main(TINY + ["--remat", r, "--log_path", str(tmp_path / r)])
            for r in ("false", "true")]
    assert [o["model"].remat for o in outs] == [False, True]
    a, b = losses(outs[0]), losses(outs[1])
    assert len(a) == 2 and np.isfinite(a).all()
    np.testing.assert_allclose(b, a, rtol=EQUAL, atol=0)
    for p, q in zip(outs[0]["model"].parameters(), outs[1]["model"].parameters()):
        assert rel_l2(q.detach(), p.detach()) <= EQUAL
