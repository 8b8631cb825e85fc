"""The port's train loop and CLI (dpot_tpu_torch/train/loop.py,
dpot_tpu_torch/cli/train.py) end to end on the CPU at a tiny size: epochs,
metrics, checkpoints that the serve CLI loads (written on the asynchronous
writer's thread), exact resume, the loss-explosion rollback with device or
host snapshots, and the options of the JAX loop."""

import json

import numpy as np
import pytest
import torch

from dpot_tpu_torch.cli.train import main
from dpot_tpu_torch.data.registry import make_synthetic_spec
from dpot_tpu_torch.train import loop
from dpot_tpu_torch.utils.config import TrainConfig

TINY = ["--model", "DPOT", "--res", "16", "--patch_size", "4", "--width", "32",
        "--n_layers", "2", "--n_blocks", "4", "--modes", "4", "--T_in", "6",
        "--batch_size", "8", "--num_workers", "2", "--lr", "1e-3", "--warmup_epochs", "1",
        "--use_writer", "true", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _specs():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    make_synthetic_spec("synthetic_tloop", train_size=16, test_size=4, t_total=12,
                        t_test=3, in_size=(16, 16), n_channels=2)
    yield
    torch.set_num_threads(n)


def tags(log_dir, tag):
    with open(f"{log_dir}/metrics.jsonl") as f:
        return [r["value"] for r in map(json.loads, f) if r["tag"] == tag]


def test_cli_trains_evaluates_and_writes_a_servable_checkpoint(tmp_path):
    out = main(TINY + ["--train_paths", "synthetic_tloop", "--epochs", "2",
                       "--noise_scale", "0.01", "--log_path", str(tmp_path)])
    log_dir = out["log_dir"]
    steps = tags(log_dir, "train_loss_step")
    assert len(steps) == 4 and np.isfinite(steps).all()  # 2 steps per epoch
    assert np.isfinite(tags(log_dir, "test_loss_full_synthetic_tloop")).all()
    assert np.isfinite(out["train_l2_step"]) and out["state"].step == 4
    assert out["state"].optimizer.count == 4

    from dpot_tpu_torch.cli.serve import _build_served

    cfg = TrainConfig(model="DPOT", res=16, patch_size=4, width=32, n_layers=2,
                      n_blocks=4, modes=4, T_in=6, n_channels=2,
                      train_paths=["synthetic_tloop"],
                      resume_path=f"{log_dir}/model/model.pth")
    served = _build_served(cfg, "cpu")
    for k, v in out["model"].state_dict().items():
        torch.testing.assert_close(served.state_dict()[k], v, rtol=0, atol=0)


def test_runs_in_one_second_get_a_log_directory_each(tmp_path, monkeypatch):
    """Two runs whose timestamps agree (time.strftime patched to a constant)
    write into two directories: the first keeps the JAX loop's name, the
    second takes the suffix _1, and each holds its own run's metrics and
    checkpoint."""
    monkeypatch.setattr(loop.time, "strftime", lambda fmt: "1018_01_26_01")
    argv = TINY + ["--train_paths", "synthetic_tloop", "--epochs", "1",
                   "--log_path", str(tmp_path)]
    first = main(argv)
    second = main(argv + ["--lr", "3e-3"])
    assert first["log_dir"] == str(tmp_path / "1018_01_26_01")
    assert second["log_dir"] == str(tmp_path / "1018_01_26_01_1")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["1018_01_26_01", "1018_01_26_01_1"]
    for out in (first, second):
        assert len(tags(out["log_dir"], "train_loss_step")) == 2  # its own 2 steps
        saved = torch.load(f"{out['log_dir']}/model/model.pth", weights_only=False)["model"]
        for k, v in out["state"].params_state_dict().items():
            torch.testing.assert_close(saved[k], v, rtol=0, atol=0)
    assert tags(first["log_dir"], "train_loss_step") != tags(second["log_dir"],
                                                             "train_loss_step")


def test_kill_and_resume_continues_step_for_step(tmp_path):
    """Three epochs uninterrupted against two epochs, a checkpoint and a
    resume for the third (the same 3-epoch config, so the same schedule):
    params, moments, step, noise stream and loader epoch all carry over, so
    the third epoch's losses are the same."""
    base = TINY + ["--train_paths", "synthetic_tloop", "--epochs", "3",
                   "--noise_scale", "0.05", "--rollback_factor", "0", "--seed", "3",
                   "--ckpt_bucket_epochs", "2"]
    full = main(base + ["--log_path", str(tmp_path / "full")])
    resumed = main(base + ["--log_path", str(tmp_path / "resumed"),
                           "--resume_path", f"{full['log_dir']}/model_0"])
    a, b = tags(full["log_dir"], "train_loss_step"), tags(resumed["log_dir"], "train_loss_step")
    assert len(a) == 6 and len(b) == 2
    np.testing.assert_allclose(b, a[4:], rtol=0, atol=1e-6)
    for p, q in zip(full["model"].parameters(), resumed["model"].parameters()):
        torch.testing.assert_close(q, p, rtol=1e-6, atol=1e-7)


def test_nan_loss_rolls_back_to_the_last_good_state(tmp_path, monkeypatch):
    """The first two losses read back are NaN: each restores the snapshot,
    even before a finite loss has seeded the EMA."""
    calls = {"n": 0}
    real = loop._fetch

    def fake_fetch(t):
        calls["n"] += 1
        return float("nan") if calls["n"] <= 4 else real(t)  # two fetches per step

    monkeypatch.setattr(loop, "_fetch", fake_fetch)
    snaps = []
    real_snapshot = loop._snapshot
    monkeypatch.setattr(loop, "_snapshot", lambda s: snaps.append(real_snapshot(s)) or snaps[-1])
    restored = []
    real_restore = loop._restore
    monkeypatch.setattr(loop, "_restore",
                        lambda s, snap: restored.append(snap) or real_restore(s, snap))
    out = main(TINY + ["--train_paths", "synthetic_tloop", "--epochs", "1",
                       "--rollback_factor", "2", "--rollback_snapshot_steps", "1",
                       "--log_path", str(tmp_path)])
    logs = open(f"{out['log_dir']}/logs.txt").read()
    assert logs.count("restoring previous good state") == 2
    assert len(restored) == 2 and all(any(r is s for s in snaps) for r in restored)


@pytest.mark.parametrize("override", [
    dict(mesh_data=2), dict(mesh_spatial=2), dict(mesh_model=2), dict(mesh_pipe=2),
    dict(shard_params="fsdp"), dict(viz_dir="viz"),
])
def test_options_not_ported_raise(override):
    """Every option of the JAX loop is ported: mesh_data, the spatial, model
    and pipe axes and shard_params=fsdp raise in one process without a
    process group (mesh axes that do not make the world size, and FSDP
    without torchrun's group), and viz_dir, the last option ported, builds
    the run."""
    cfg = TrainConfig(model="DPOT", train_paths=["synthetic_tloop"], res=16, patch_size=4,
                      width=32, n_layers=1, n_blocks=4, modes=4, T_in=6, **override)
    if "viz_dir" in override:
        assert loop.build_everything(cfg, device="cpu")[1].step == 0
        return
    axes = (ValueError, "mesh axes .* do not make the 1 ranks")
    exc, match = {"mesh_data": (ValueError, "mesh_data=2 does not match the 1 ranks"),
                  "mesh_spatial": axes, "mesh_model": axes, "mesh_pipe": axes,
                  "shard_params": (RuntimeError, "process group")}[next(iter(override))]
    with pytest.raises(exc, match=match):
        loop.build_everything(cfg, device="cpu")


def test_cuda_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    argv = [a for a in TINY if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv + ["--train_paths", "synthetic_tloop", "--epochs", "1"])


# -- asynchronous checkpoints (train/checkpoint.py AsyncCheckpointWriter) --

def load_ckpt(path):
    return torch.load(f"{path}/model.pth", weights_only=False)


def assert_same_checkpoint(a: dict, b: dict) -> None:
    """Every tensor bit for bit, the step, the generator and the args."""
    assert list(a) == list(b) and a["step"] == b["step"]
    assert torch.equal(a["generator"], b["generator"]) and vars(a["args"]) == vars(b["args"])
    assert list(a["model"]) == list(b["model"])
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    oa, ob = a["optimizer"], b["optimizer"]
    assert oa["count"] == ob["count"] and torch.equal(oa["grad_norm"], ob["grad_norm"])
    for key in ("mu", "nu"):
        assert all(torch.equal(x, y) for x, y in zip(oa[key], ob[key], strict=True))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trained")
    return main(TINY + ["--train_paths", "synthetic_tloop", "--epochs", "1",
                        "--log_path", str(tmp)])


def test_async_checkpoint_equals_the_synchronous_one(trained, tmp_path):
    """The payload is copied in the call: the state changed in place right
    after the submit does not reach the file, which equals a synchronous
    save of the state as it was, bit for bit (config.json too)."""
    from dpot_tpu_torch.train.checkpoint import AsyncCheckpointWriter, save_checkpoint

    state, cfg = trained["state"], {"lr": 1e-3, "paths": ["a", "b"]}
    save_checkpoint(str(tmp_path / "sync"), state, config=cfg)
    with AsyncCheckpointWriter() as w:
        path = save_checkpoint(str(tmp_path / "async"), state, config=cfg, writer=w)
        with torch.no_grad():
            for p in state.optimizer.params + state.optimizer.mu:
                p.add_(1.0)
            state.generator.manual_seed(99)
        cfg["paths"].append("c")
    assert path == str(tmp_path / "async" / "model.pth")
    assert_same_checkpoint(load_ckpt(tmp_path / "async"), load_ckpt(tmp_path / "sync"))
    assert (open(tmp_path / "async" / "config.json").read()
            == open(tmp_path / "sync" / "config.json").read())
    with torch.no_grad():  # the module's fixture state as it was
        for p in state.optimizer.params + state.optimizer.mu:
            p.sub_(1.0)


def test_failed_async_write_surfaces_and_the_thread_stops(trained, tmp_path, monkeypatch):
    """A write that fails on the thread raises at the next submit, or at
    wait or close; close stops the thread in every case."""
    from dpot_tpu_torch.train import checkpoint

    def broken_save(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint.torch, "save", broken_save)
    w = checkpoint.AsyncCheckpointWriter()
    checkpoint.save_checkpoint(str(tmp_path / "a"), trained["state"], writer=w)
    w._q.join()  # the write has failed on the thread
    with pytest.raises(RuntimeError, match="checkpoint write failed") as err:
        checkpoint.save_checkpoint(str(tmp_path / "b"), trained["state"], writer=w)
    assert isinstance(err.value.__cause__, OSError)
    w.wait()  # that submit raised before queueing: nothing is pending
    checkpoint.save_checkpoint(str(tmp_path / "b"), trained["state"], writer=w)
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        w.wait()
    w.close()
    w._thread.join(timeout=10)
    assert not w._thread.is_alive()

    w = checkpoint.AsyncCheckpointWriter()
    checkpoint.save_checkpoint(str(tmp_path / "c"), trained["state"], writer=w)
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        w.close()
    w._thread.join(timeout=10)
    assert not w._thread.is_alive()


def test_train_returns_once_its_checkpoints_are_written(tmp_path, monkeypatch):
    """With async_ckpt (the default) every write goes through the writer's
    thread, and train() returns after the last one is on disk and the
    thread has stopped: each save waits a moment on the thread here."""
    import threading
    import time

    from dpot_tpu_torch.train import checkpoint

    real, written = checkpoint._write_payload, []

    def slow_write(path, payload, config):
        time.sleep(0.3)
        written.append(threading.current_thread().name)
        return real(path, payload, config)

    monkeypatch.setattr(checkpoint, "_write_payload", slow_write)
    out = main(TINY + ["--train_paths", "synthetic_tloop", "--epochs", "2",
                       "--log_path", str(tmp_path)])
    assert written == ["checkpoint-writer"] * 2
    assert not any(t.name == "checkpoint-writer" for t in threading.enumerate())
    saved = load_ckpt(f"{out['log_dir']}/model")
    assert saved["step"] == out["state"].step == 4
    for k, v in out["state"].params_state_dict().items():
        assert torch.equal(saved["model"][k], v), k


# -- rollback snapshots on the host (train/loop.py snapshot_mode) --

class _Limit:
    """A device whose memory_stats report `bytes_limit`."""

    def __init__(self, limit):
        self.limit = limit

    def memory_stats(self):
        return {"bytes_limit": self.limit} if self.limit else {}


def test_snapshot_mode_follows_jax_s_rule(monkeypatch):
    """Host when two copies of the rollback's bytes exceed 80 % of the
    card's memory, device below that and without a limit (a CPU), and
    DPOT_SNAPSHOT_MODE overriding the rule: the same decisions as JAX's
    _choose_snapshot_fn on the same tensors' bytes."""
    import jax
    import jax.numpy as jnp

    from dpot_tpu.train import loop as jax_loop

    cfg = TrainConfig(model="DPOT", train_paths=["synthetic_tloop"], res=16, patch_size=4,
                      width=32, n_layers=2, n_blocks=4, modes=4, T_in=6)
    state = loop.build_everything(cfg, device="cpu")[1]
    params = {k: jnp.asarray(v.detach().numpy())
              for k, v in state.model.named_parameters()}
    jax_state = type("S", (), dict(params=params, opt_state=(params, params)))
    _, per_dev, limit = loop.snapshot_mode(state)
    assert limit is None
    assert per_dev == 3 * sum(4 * p.size for p in params.values())

    class Text:
        def text(self, s):
            pass

    threshold = 2 * per_dev / 0.8
    for env in ("", "device", "host"):
        monkeypatch.setenv("DPOT_SNAPSHOT_MODE", env)
        for f in (None, 0.5, 0.999, 1.001, 3.0):
            lim = None if f is None else int(threshold * f)
            monkeypatch.setattr(loop, "_memory_limit", lambda device, lim=lim: lim)
            monkeypatch.setattr(jax, "devices", lambda lim=lim: [_Limit(lim)])
            fn = jax_loop._choose_snapshot_fn(jax_state, Text())
            want = "host" if fn is jax_loop._host_snapshot else "device"
            assert loop.snapshot_mode(state)[0] == want, (env, f)
            assert want == (env or ("host" if f and f < 1 else "device"))


def test_host_snapshots_roll_back_as_device_ones_do(tmp_path, monkeypatch):
    """Two forced rollbacks (NaN losses) with DPOT_SNAPSHOT_MODE=host and
    =device: the same snapshots taken and restored, the same final state,
    bit for bit; the log names the mode and the bytes."""
    def run(mode):
        monkeypatch.setenv("DPOT_SNAPSHOT_MODE", mode)
        calls = {"n": 0}
        real = loop._fetch

        def fake_fetch(t):
            calls["n"] += 1
            return float("nan") if calls["n"] in (3, 4, 7, 8) else real(t)

        monkeypatch.setattr(loop, "_fetch", fake_fetch)
        restored = []
        real_restore = loop._restore
        monkeypatch.setattr(loop, "_restore", lambda s, snap: restored.append(
            [t.clone() for t in snap]) or real_restore(s, snap))
        out = main(TINY + ["--train_paths", "synthetic_tloop", "--epochs", "2",
                           "--rollback_factor", "2", "--rollback_snapshot_steps", "1",
                           "--seed", "5", "--log_path", str(tmp_path / mode)])
        monkeypatch.setattr(loop, "_fetch", real)
        monkeypatch.setattr(loop, "_restore", real_restore)
        logs = open(f"{out['log_dir']}/logs.txt").read()
        assert f"rollback snapshots on {mode.upper()}" in logs and "bytes" in logs
        assert logs.count("restoring previous good state") == 2
        return restored, loop._rollback_tensors(out["state"])

    host, host_final = run("host")
    device, device_final = run("device")
    assert len(host) == len(device) == 2
    for a, b in zip(host + [host_final], device + [device_final]):
        assert all(torch.equal(x, y) for x, y in zip(a, b, strict=True))
