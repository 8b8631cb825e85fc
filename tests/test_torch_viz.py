"""The port's visuals (dpot_tpu_torch/utils/viz.py, its own copy of the JAX
package's numpy + matplotlib module) and `viz_dir` in its train loop and
evaluator, on the CPU at a tiny size: `train()` and `evaluate()` (2D and
3D) write, for the samples they pass, the same file names and the same
decoded pixels (PIL) as the JAX package's `save_eval_viz` of those samples,
and the other plots match JAX's likewise. Where
matplotlib is absent every function writes nothing and returns False or
[]."""

import os

import numpy as np
import pytest
import torch

from dpot_tpu.utils import viz as jax_viz
from dpot_tpu_torch.cli.train import main
from dpot_tpu_torch.data.registry import make_synthetic_spec
from dpot_tpu_torch.models import build_model
from dpot_tpu_torch.train import evaluator
from dpot_tpu_torch.utils import viz

TRAIN_SET, SET_3D = "synthetic_torch_viz", "synthetic_torch_viz3d"
TINY = ["--model", "DPOT", "--res", "16", "--patch_size", "4", "--width", "16",
        "--n_layers", "1", "--n_blocks", "2", "--modes", "4", "--T_in", "4",
        "--batch_size", "4", "--num_workers", "1", "--warmup_epochs", "1",
        "--device", "cpu"]
CFG_3D = dict(img_size=8, patch_size=4, in_channels=2, out_channels=2, in_timesteps=3,
              out_timesteps=1, embed_dim=16, depth=1, n_blocks=2, modes=2, n_cls=1)


@pytest.fixture(autouse=True, scope="module")
def _specs():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    make_synthetic_spec(TRAIN_SET, train_size=8, test_size=4, t_total=6, t_test=2,
                        in_size=(16, 16), n_channels=2)
    make_synthetic_spec(SET_3D, train_size=2, test_size=2, t_total=5, t_test=2,
                        in_size=(8, 8, 8), n_channels=2)
    yield
    torch.set_num_threads(n)


def pixels(path) -> list[np.ndarray]:
    """The decoded frames of a PNG or GIF."""
    from PIL import Image, ImageSequence

    with Image.open(path) as im:
        return [np.asarray(f.convert("RGBA")) for f in ImageSequence.Iterator(im)]


def assert_same_files(got_dir, want_dir) -> None:
    got, want = sorted(os.listdir(got_dir)), sorted(os.listdir(want_dir))
    assert got == want
    for name in got:
        a, b = pixels(os.path.join(got_dir, name)), pixels(os.path.join(want_dir, name))
        assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b)), name


def test_the_other_plots_match_jax(tmp_path):
    traj = np.random.default_rng(0).standard_normal((8, 8, 2, 1)).astype(np.float32)
    for mod, sub in ((viz, "port"), (jax_viz, "jax")):
        d = tmp_path / sub
        d.mkdir()
        mod.plot_trajectory(traj, str(d / "traj.png"), title="t")
        mod.plot_snapshots(traj, str(d / "snap"), n_frames=2)
        mod.plot_channels(traj, str(d / "ch"), channel_names=["u"])
        mod.plot_histograms(traj, str(d / "hist.png"))
        mod.plot_statistics(traj, str(d / "stats.png"))
    if viz._plt() is not None:
        assert len(os.listdir(tmp_path / "port")) == 6
    assert_same_files(tmp_path / "port", tmp_path / "jax")


def test_without_matplotlib_nothing_is_written(tmp_path, monkeypatch):
    monkeypatch.setattr(viz, "_plt", lambda: None)
    traj = np.zeros((8, 8, 2, 1), np.float32)
    assert viz.save_eval_viz(traj, traj, str(tmp_path), "a") == []
    assert viz.plot_volume(np.zeros((4, 4, 4)), str(tmp_path / "v.png")) is False
    assert os.listdir(tmp_path) == []


def spy(monkeypatch, calls):
    """Record what the port passes to save_eval_viz, and pass it on."""
    real = viz.save_eval_viz

    def spied(pred, target, out_dir, dataset, channel=0):
        calls.append((pred, target, dataset))
        return real(pred, target, out_dir, dataset, channel)

    monkeypatch.setattr(viz, "save_eval_viz", spied)


def jax_files_for(calls, out_dir) -> None:
    for pred, target, dataset in calls:
        jax_viz.save_eval_viz(pred, target, str(out_dir), dataset)


def test_train_writes_the_final_epochs_visuals(tmp_path, monkeypatch):
    """One call per test set, in the final epoch only, with the first
    sample of the first batch, masked; the files JAX writes for it."""
    calls = []
    spy(monkeypatch, calls)
    out = main(TINY + ["--train_paths", TRAIN_SET, "--epochs", "2",
                       "--viz_dir", str(tmp_path / "port")])
    assert [c[2] for c in calls] == [TRAIN_SET]
    pred, target, _ = calls[0]
    assert pred.shape == target.shape == (16, 16, 2, 2) and np.isfinite(pred).all()
    assert out["state"].step == 4
    jax_files_for(calls, tmp_path / "jax")
    if viz._plt() is not None:
        assert sorted(os.listdir(tmp_path / "port")) == [f"{TRAIN_SET}_rollout.gif",
                                                         f"{TRAIN_SET}_rollout.png"]
    assert_same_files(tmp_path / "port", tmp_path / "jax")


@pytest.mark.parametrize("dim", [2, 3])
def test_evaluate_writes_the_first_batch_of_each_set(dim, tmp_path, monkeypatch):
    """2D and DPOT3D: the first sample of each set's first batch, the
    prediction and the target masked as JAX masks them; the 3D set's
    mid-Z plane and volume."""
    calls = []
    spy(monkeypatch, calls)
    if dim == 2:
        model = build_model("DPOT", device="cpu", seed=0, img_size=16, patch_size=4,
                            in_channels=2, in_timesteps=4, embed_dim=16, depth=1,
                            n_blocks=2, modes=4, n_cls=1)
        kw, name = dict(res=16, t_in=4), TRAIN_SET
    else:
        model = build_model("DPOT3D", device="cpu", seed=0, **CFG_3D)
        kw, name = dict(res=8, t_in=3), SET_3D
    evaluator.evaluate(model, [name], batch_size=2, num_workers=1,
                       viz_dir=str(tmp_path / "port"), **kw)
    assert [c[2] for c in calls] == [name]
    pred, target, _ = calls[0]
    ds = evaluator._test_dataset(name, n_channels=None, **kw)
    _, y, msk, _ = ds[0]
    np.testing.assert_array_equal(target, y * msk)
    assert pred.shape == target.shape and np.isfinite(pred).all()
    jax_files_for(calls, tmp_path / "jax")
    if viz._plt() is not None:
        want = {f"{name}_rollout.gif", f"{name}_rollout.png"} | (
            {f"{name}_volume.png"} if dim == 3 else set())
        assert set(os.listdir(tmp_path / "port")) == want
    assert_same_files(tmp_path / "port", tmp_path / "jax")
