"""One dispatch per K train steps, per eval rollout and per served rollout
(dpot_tpu_torch/train/step.py `scan_steps`, train/loop.py
`steps_per_dispatch`, ops/cuda/graphs.py) on the CPU at a small size.

On the CPU a K-step dispatch is K eager steps and the rollouts run eagerly,
so these tests hold the host side: the stacked batches and aux, the
optimizer's per-step scalars, the loop's dispatch units, drain and
rollback, and the capture hazards that can be reported without a card
(a cached bf16 weight copy, a cache miss under capture, the serve cache's
compile count). The graphs themselves are held against eager runs on the
card (tests/test_torch_gpu.py, chip_smoke.py). Weights are drawn by the
port and carried into the JAX package by `dpot_params_from_torch`; batches
and noise come from numpy. JAX's f32 model takes its rfft path and the
port its combined DFT operators, so weights are held to the interop bar of
PARITY.md, 2e-4.
"""

import json
import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from dpot_tpu.data.registry import make_synthetic_spec as jax_make_synthetic_spec
from dpot_tpu.models import build_model as jax_build_model
from dpot_tpu.train.interop import dpot_params_from_torch
from dpot_tpu.train.loop import _opt_steps_per_epoch as jax_opt_steps_per_epoch
from dpot_tpu.train.loop import train as jax_train
from dpot_tpu.train.optimizers import build_optimizer as jax_build_optimizer
from dpot_tpu.train.schedules import onecycle as jax_onecycle
from dpot_tpu.train.schedules import onecycle_momentum as jax_onecycle_momentum
from dpot_tpu.train.state import TrainState as JaxTrainState
from dpot_tpu.train.step import make_train_step as jax_train_step
from dpot_tpu.utils.config import TrainConfig as JaxTrainConfig
from dpot_tpu_torch.data.registry import make_synthetic_spec
from dpot_tpu_torch.models import build_model
from dpot_tpu_torch.models.dpot import DPOTNet, grid_patches
from dpot_tpu_torch.ops.cuda import afno_fused, graphs
from dpot_tpu_torch.ops.spectral import combined_spectral_ops
from dpot_tpu_torch.serve import RolloutServer
from dpot_tpu_torch.train import loop
from dpot_tpu_torch.train import optimizers as port_opt
from dpot_tpu_torch.train.interop import state_dict_from_jax
from dpot_tpu_torch.train.optimizers import build_optimizer
from dpot_tpu_torch.train.schedules import onecycle, onecycle_momentum
from dpot_tpu_torch.train.state import TrainState
from dpot_tpu_torch.train.step import make_train_step
from dpot_tpu_torch.utils.config import TrainConfig

CFG = dict(img_size=16, patch_size=4, in_channels=2, out_channels=2, in_timesteps=4,
           out_timesteps=1, embed_dim=32, depth=2, n_blocks=4, modes=4, n_cls=2)
NOISE = 0.05
BAR = 2e-4
K = 3


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _numpy_host_paths(monkeypatch):
    """Both packages' numpy host paths, which give the same batches bit for
    bit (the native resize rounds differently from numpy; native against
    native is tests/test_torch_native.py and test_torch_loader_native.py)."""
    import dpot_tpu.native.preprocess as pre
    import dpot_tpu_torch.native.preprocess as port_pre

    monkeypatch.setattr(pre, "get_library", lambda: None)
    monkeypatch.setattr(port_pre, "get_library", lambda: None)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def make_batches(seed, k=K, B=4, t_ar=2):
    """k stacked batches: x, y, a mask that zeroes every other row of one
    sample, cls, and the standard-normal noise draws (k, n_steps, *x)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    msk = np.ones((k, B, 16, 16, 1, 2), f)
    msk[:, 0, ::2] = 0.0
    return dict(
        x=(1.0 + rng.standard_normal((k, B, 16, 16, 4, 2))).astype(f),
        y=(1.0 + rng.standard_normal((k, B, 16, 16, t_ar, 2))).astype(f),
        msk=msk,
        cls=rng.integers(0, 2, (k, B)).astype(np.int32),
        noise=rng.standard_normal((k, t_ar, B, 16, 16, 4, 2)).astype(f),
    )


def to_torch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def port_state(opt="adam", seed=0):
    model = build_model("DPOT", device="cpu", seed=seed, **CFG)
    sched = onecycle(3e-3, 6, 1, 3)
    tx = build_optimizer(opt, model.parameters(), sched, onecycle_momentum(6, 1, 3),
                         beta2=0.9, grad_clip=1.0)
    return TrainState.create(model, tx, seed=5)


def jax_state(model, opt="adam"):
    # copies: JAX may alias a numpy buffer, which the port updates in place
    params = dpot_params_from_torch({k: v.detach().numpy().copy() for k, v in
                                     model.state_dict().items()},
                                    depth=CFG["depth"], normalize=False)
    tx = jax_build_optimizer(opt, jax_onecycle(3e-3, 6, 1, 3), jax_onecycle_momentum(6, 1, 3),
                             beta2=0.9, grad_clip=1.0)
    return JaxTrainState.create(jax_build_model("DPOT", **CFG).apply, params, tx,
                                jax.random.key(0))


# ------------------------------------------------ make_train_step(scan_steps)


@pytest.mark.parametrize("noise", ["generator", "external"])
def test_k_steps_equal_k_sequential_steps(noise):
    """scan_steps=3 against three calls of the one-step function on the same
    batches: every loss, aux leaf and weight bitwise equal, the aux stacked
    (3,), the step and the optimizer's count advanced by 3. The noise comes
    from the state's generator (threaded through the three steps) or from
    the external draws."""
    batches = make_batches(0)
    if noise == "generator":
        del batches["noise"]
    a = port_state()
    a, aux = make_train_step(noise_scale=NOISE, scan_steps=K)(a, to_torch(batches))
    b = port_state()
    step = make_train_step(noise_scale=NOISE)
    seq = [step(b, {k: v[i] for k, v in to_torch(batches).items()})[1] for i in range(K)]
    assert a.step == b.step == K and a.optimizer.count == K
    for name, v in aux.items():
        assert v.shape == (K,), name
        torch.testing.assert_close(v, torch.stack([s[name] for s in seq]), rtol=0, atol=0)
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
    for m, n in zip(a.optimizer.mu + a.optimizer.nu, b.optimizer.mu + b.optimizer.nu):
        torch.testing.assert_close(m, n, rtol=0, atol=0)
    torch.testing.assert_close(a.optimizer.grad_norm, b.optimizer.grad_norm, rtol=0, atol=0)


@pytest.mark.parametrize("noise_scale", [NOISE, 0.0])
def test_k_steps_match_jax_scan_steps(noise_scale):
    """scan_steps=3 against the JAX package's (one lax.scan) from the same
    weights and batches, with a OneCycle lr and cycled b1, the noise shared
    through the external draws or off: the (3,) losses within 1e-5
    relative, the weights within the interop bar."""
    batches = make_batches(1)
    state = port_state()
    jstate = jax_state(state.model)
    jstate, jaux = jax_train_step(noise_scale=noise_scale, donate=False, scan_steps=K)(
        jstate, {k: jnp.asarray(v) for k, v in batches.items()})
    state, aux = make_train_step(noise_scale=noise_scale, scan_steps=K)(state, to_torch(batches))
    for name in ("loss_step", "loss_full", "cls_loss"):
        np.testing.assert_allclose(aux[name].numpy(), np.asarray(jaux[name]), rtol=1e-5)
    assert int(jstate.step) == state.step == K
    want = state_dict_from_jax(jax.device_get(jstate.params))
    for name, p in state.model.named_parameters():
        assert rel_l2(p.detach().numpy(), want[name].numpy()) <= BAR, name


def test_grad_accum_composes_with_scan_steps():
    """grad_accum=2 inside each of two dispatched steps: bitwise the two
    sequential grad_accum steps; against JAX's (grad_accum=2,
    scan_steps=2), noise off: losses within 1e-5, weights within the bar."""
    batches = make_batches(2, k=2)
    del batches["noise"]
    kw = dict(grad_accum=2)
    a = port_state(opt="lamb")
    jstate = jax_state(a.model, opt="lamb")
    a, aux = make_train_step(scan_steps=2, **kw)(a, to_torch(batches))
    b = port_state(opt="lamb")
    step = make_train_step(**kw)
    seq = [step(b, {k: v[i] for k, v in to_torch(batches).items()})[1] for i in range(2)]
    torch.testing.assert_close(aux["loss_step"], torch.stack([s["loss_step"] for s in seq]),
                               rtol=0, atol=0)
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
    jstate, jaux = jax_train_step(donate=False, scan_steps=2, **kw)(
        jstate, {k: jnp.asarray(v) for k, v in batches.items()})
    np.testing.assert_allclose(aux["loss_step"].numpy(), np.asarray(jaux["loss_step"]),
                               rtol=1e-5)
    want = state_dict_from_jax(jax.device_get(jstate.params))
    for name, p in a.model.named_parameters():
        assert rel_l2(p.detach().numpy(), want[name].numpy()) <= BAR, name


def test_scan_steps_checks_the_leading_axis():
    batches = to_torch(make_batches(3, k=2))
    with pytest.raises(ValueError, match="scan_steps=3"):
        make_train_step(scan_steps=K)(port_state(), batches)


# ------------------------------------------------ the optimizer's step values


@pytest.mark.parametrize("name", ["adam", "adamw", "lamb"])
def test_optimizer_step_values_match_jax(name):
    """Five scheduled updates (OneCycle lr, cycled b1, an active clip) fed
    the rows of one `values_at` table, as a 5-step dispatch reads them,
    against the JAX optimizer: the params within 1e-6 relative; and the
    default per-step rows give the same params bit for bit."""
    import optax

    rng = np.random.default_rng(4)
    shapes = {"a": (4, 6), "b": (6,), "c": (2, 3, 5)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (3 * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]
    kw = dict(beta2=0.9, grad_clip=2.0, weight_decay=1e-2)
    tx = jax_build_optimizer(name, jax_onecycle(1e-2, 5, 1, 3), jax_onecycle_momentum(5, 1, 3),
                             **kw)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    st = tx.init(jp)
    runs = []
    for table in (True, False):
        params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
        opt = port_opt.build_optimizer(name, params.values(), onecycle(1e-2, 5, 1, 3),
                                       onecycle_momentum(5, 1, 3), **kw)
        values = opt.values_at(range(5)) if table else [None] * 5
        assert not table or values.shape == (5, port_opt.N_VALUES)
        for g, v in zip(grads, values):
            for k, p in params.items():
                p.grad = torch.from_numpy(g[k])
            opt.step(values=v)
        runs.append(params)
    for g in grads:
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)
    for k in shapes:
        torch.testing.assert_close(runs[0][k], runs[1][k], rtol=0, atol=0)
        assert rel_l2(runs[0][k].detach().numpy(), jp[k]) <= 1e-6, k


# ------------------------------------------------ the loop at steps_per_dispatch

LOOP = dict(model="DPOT", train_paths=["synthetic_fuse"], res=16, patch_size=4, width=32,
            n_layers=1, n_blocks=4, modes=4, T_in=6, batch_size=8, epochs=2, num_workers=2,
            lr=1e-3, opt="adam", lr_method="cycle", rollback_factor=0.0, use_writer=True,
            seed=11)


@pytest.fixture(scope="module")
def fuse_data():
    kw = dict(train_size=40, test_size=8, t_total=12, t_test=2, in_size=(16, 16),
              n_channels=1)
    make_synthetic_spec("synthetic_fuse", **kw)
    jax_make_synthetic_spec("synthetic_fuse", **kw)


def train_losses(log_dir):
    with open(f"{log_dir}/metrics.jsonl") as f:
        recs = [r for r in map(json.loads, f) if r["tag"] == "train_loss_step"]
    return [r["step"] for r in recs], [r["value"] for r in recs]


@pytest.fixture(scope="module")
def port_runs(fuse_data, tmp_path_factory):
    """The port's loop at steps_per_dispatch 1 and 2 with noise 0.05, and at
    2 without noise (40 samples, B = 8: two 2-step dispatches and one tail
    step an epoch)."""
    tmp = tmp_path_factory.mktemp("dispatch")
    runs = {}
    for name, kw in (("k1", dict(noise_scale=NOISE)),
                     ("k2", dict(noise_scale=NOISE, steps_per_dispatch=2)),
                     ("k2_quiet", dict(steps_per_dispatch=2))):
        runs[name] = loop.train(TrainConfig(**LOOP, **kw), log_dir=str(tmp / name),
                                device="cpu")
    return runs


def test_loop_k2_matches_k1(port_runs):
    """Ten per-step losses (5 optimizer steps an epoch at either K), the
    test losses and the final weights of steps_per_dispatch 2 against 1,
    from the same seed: the same samples, noise and schedule."""
    k1, k2 = port_runs["k1"], port_runs["k2"]
    (s1, l1), (s2, l2) = train_losses(k1["log_dir"]), train_losses(k2["log_dir"])
    assert len(l1) == len(l2) == 10 and s1 == s2 == list(range(1, 11))
    np.testing.assert_allclose(l2, l1, rtol=0, atol=1e-6)
    np.testing.assert_allclose(k2["test_l2_fulls"], k1["test_l2_fulls"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(k2["test_l2_steps"], k1["test_l2_steps"], rtol=0, atol=1e-6)
    assert k1["state"].step == k2["state"].step == 10
    assert k2["dispatch_steps"] == [2, 2, 1] * 2
    for p, q in zip(k1["model"].parameters(), k2["model"].parameters()):
        torch.testing.assert_close(q, p, rtol=0, atol=1e-6)


def test_loop_k2_matches_the_jax_loop(port_runs, tmp_path):
    """The port's loop at steps_per_dispatch 2 against the JAX package's
    from the same weights, noise off: the ten losses and the test losses
    within 1e-4 relative (the JAX package's own bar for K = 2 against 1)."""
    port = port_runs["k2_quiet"]
    model = loop.build_everything(TrainConfig(**LOOP), device="cpu")[0]
    params = dpot_params_from_torch({k: v.numpy().copy() for k, v in
                                     model.state_dict().items()},
                                    depth=LOOP["n_layers"], normalize=False)
    out = jax_train(JaxTrainConfig(**LOOP, steps_per_dispatch=2), log_dir=str(tmp_path),
                    init_params=params)
    (sp, lp), (sj, lj) = train_losses(port["log_dir"]), train_losses(tmp_path)
    assert sp == sj and len(lp) == 10
    np.testing.assert_allclose(lp, lj, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(port["test_l2_fulls"], out["test_l2_fulls"], rtol=1e-4)
    assert int(jax.device_get(out["state"].step)) == port["state"].step == 10


@pytest.mark.parametrize("n,B,K", [(40, 8, 2), (38, 8, 2), (41, 8, 4), (7, 8, 3)])
def test_opt_steps_per_epoch_matches_jax(n, B, K):
    """Optimizer steps an epoch, the schedule's unit: ceil(n / B) at any K."""
    for k in (1, K):
        cfg = types.SimpleNamespace(steps_per_dispatch=k, batch_size=B)
        dl, ds = range(-(-n // (B * k))), range(n)
        assert loop._opt_steps_per_epoch(cfg, dl, ds) == jax_opt_steps_per_epoch(cfg, dl, ds)
    assert loop._opt_steps_per_epoch(
        types.SimpleNamespace(steps_per_dispatch=K, batch_size=B), range(0), range(n)
    ) == max(-(-n // B), 1)


def test_explosion_in_a_dispatch_keeps_its_later_sub_steps_out(fuse_data, tmp_path,
                                                               monkeypatch):
    """A NaN at sub-step 1 of the first 2-step dispatch restores the last
    good state once, and sub-step 2 of that dispatch enters neither the
    logged losses nor the epoch's samples: four of five steps logged."""
    calls = {"n": 0}
    real = loop._fetch_rows

    def fetch_rows(*ts):
        calls["n"] += 1
        rows = real(*ts)
        if calls["n"] == 1:
            rows[0][0] = float("nan")
        return rows

    monkeypatch.setattr(loop, "_fetch_rows", fetch_rows)
    restored = []
    real_restore = loop._restore
    monkeypatch.setattr(loop, "_restore",
                        lambda s, snap: restored.append(snap) or real_restore(s, snap))
    out = loop.train(TrainConfig(**{**LOOP, "epochs": 1, "rollback_factor": 2.0},
                                 steps_per_dispatch=2), log_dir=str(tmp_path), device="cpu")
    steps, losses = train_losses(tmp_path)
    assert len(restored) == 1
    # a non-finite value is logged as null
    assert steps == [1, 3, 4, 5] and losses[0] is None and np.isfinite(losses[1:]).all()
    assert open(f"{tmp_path}/logs.txt").read().count("restoring previous good state") == 1
    assert out["state"].step == 5


# ------------------------------------------------ capture hazards, reported on the CPU


def _report_capture(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)


def test_bf16_blocks_never_hand_a_cached_copy_to_a_capture(monkeypatch):
    """Outside capture the bf16 copy is cached until w changes; while a
    capture is reported every call converts afresh and the cache keeps
    what it had."""
    w = torch.nn.Parameter(torch.randn(2, 4, 8, 8))
    first = afno_fused._bf16_blocks(w)
    assert afno_fused._bf16_blocks(w) is first
    with monkeypatch.context() as m:
        _report_capture(m)
        a, b = afno_fused._bf16_blocks(w), afno_fused._bf16_blocks(w)
    assert a is not first and b is not a
    torch.testing.assert_close(a, first, rtol=0, atol=0)
    assert w._dpot_bf16_blocks[1] is first
    with torch.no_grad():
        w.mul_(2.0)
    torch.testing.assert_close(afno_fused._bf16_blocks(w), 2.0 * first, rtol=0, atol=0)


def test_device_constant_miss_under_capture_raises(monkeypatch):
    """A cache miss of the DFT operators or grid channels while a capture is
    reported raises, naming the shape, instead of uploading."""
    _report_capture(monkeypatch)
    with pytest.raises(RuntimeError, match="13x11"):
        combined_spectral_ops(13, 11, 4, 4, torch.float32, torch.device("cuda"))
    with pytest.raises(RuntimeError, match="13x11"):
        grid_patches(13, 11, 3, 1, torch.float32, torch.device("cuda"))


class FakeGraph:
    """A stand-in for graphs.Graph on the CPU: `replay()` runs fn eagerly;
    `close()` marks it freed."""

    def __init__(self, fn, pool=None, generators=(), mutated=()):
        self.fn = fn
        self.closed = False

    def replay(self):
        return self.fn()

    def close(self):
        self.closed = True


def test_serve_counts_one_compile_per_bucket_and_steps(monkeypatch):
    """With the graph cache on (its captures stood in for on the CPU): start()
    captures every bucket at the warm-up step count, a new (bucket, steps)
    captures once at first use and is answered, and a seen one replays;
    `compiles` counts the captures, as the JAX server counts its compiles,
    and every answer equals a direct rollout."""
    monkeypatch.setattr(graphs, "Graph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    model = build_model("DPOT", device="cpu", seed=0, img_size=16, patch_size=4,
                        in_channels=2, in_timesteps=4, embed_dim=32, depth=1, n_blocks=4,
                        modes=4, n_cls=1)
    rs = RolloutServer(model, batch_buckets=(1, 2), max_wait_ms=0.0, warmup_steps=(1,),
                       device="cpu")
    rs._graphed = True
    rs.start()
    try:
        assert rs.metrics()["compiles"] == 2
        rng = np.random.default_rng(0)
        for b, steps, compiles in ((1, 1, 2), (2, 3, 3), (1, 3, 4), (2, 3, 4), (1, 1, 4)):
            x = rng.standard_normal((b, 16, 16, 4, 2)).astype(np.float32)
            got = rs.submit(x, steps)
            carry, want = torch.from_numpy(x), []
            with torch.no_grad():
                for _ in range(steps):
                    im = model(carry)[0]
                    want.append(im)
                    carry = torch.cat([carry[..., 1:, :], im], dim=-2)
            np.testing.assert_allclose(got, torch.cat(want, dim=-2).numpy(), rtol=0, atol=1e-6)
            assert rs.metrics()["compiles"] == compiles == rs._graphs.captures
        held = [graph for _, graph in rs._graphs._graphs.values()]
    finally:
        rs.stop(drain=True)
    # stop() freed the graphs once the worker had ended, and emptied the cache
    assert len(held) == 4 and all(g.closed for g in held) and not rs._graphs._graphs


def test_dpotnet_defaults_to_the_card():
    """Built without device=, the model goes to CUDA; without a card that
    raises resolve_device's error instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        DPOTNet(img_size=16, patch_size=4, in_channels=2, embed_dim=32, depth=1,
                n_blocks=4, modes=4)
