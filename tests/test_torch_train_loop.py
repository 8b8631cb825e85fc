"""The port's train loop and CLI (dpot_tpu_torch/train/loop.py,
dpot_tpu_torch/cli/train.py) end to end on the CPU at a tiny size: epochs,
metrics, checkpoints that the serve CLI loads, exact resume, the
loss-explosion rollback and the options that are not ported yet."""

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
    dict(shard_params="fsdp"), dict(steps_per_dispatch=2), dict(viz_dir="viz"),
])
def test_options_not_ported_raise(override):
    cfg = TrainConfig(model="DPOT", train_paths=["synthetic_tloop"], res=16, patch_size=4,
                      width=32, n_layers=1, n_blocks=4, modes=4, T_in=6, **override)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        loop.build_everything(cfg, device="cpu")


def test_cuda_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    argv = [a for a in TINY if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv + ["--train_paths", "synthetic_tloop", "--epochs", "1"])
