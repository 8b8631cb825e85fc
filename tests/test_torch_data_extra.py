"""The port's masked and steady datasets and `normalize=True`
(dpot_tpu_torch/data/grid_dataset.py) against the JAX package's: items bit
for bit for the same index and rng word, train and test, with both native
host libraries on (they share their arithmetic) and both off."""

import dataclasses

import numpy as np
import pytest
import torch

from dpot_tpu.data import grid_dataset as jax_gd
from dpot_tpu.data import registry as jax_registry
from dpot_tpu.data.loader import DataLoader as JaxLoader
from dpot_tpu.data.loader import _window_words
from dpot_tpu_torch.data import DataLoader, MixedMaskedDataset, MixedTemporalDataset
from dpot_tpu_torch.data import SteadyDataset2D, registry
from dpot_tpu_torch.data.generation import write_scatter, write_single


@pytest.fixture(autouse=True)
def _two_threads(monkeypatch):
    """Native calls and loaders on two threads: the port's library follows
    torch's thread count, the JAX package's DPOT_NATIVE_THREADS."""
    monkeypatch.setenv("DPOT_NATIVE_THREADS", "2")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=["native", "numpy"])
def host_path(request, monkeypatch):
    import dpot_tpu.native.preprocess as jax_pre
    import dpot_tpu_torch.native.preprocess as port_pre

    monkeypatch.delenv("DPOT_DISABLE_NATIVE", raising=False)
    if request.param == "numpy":
        monkeypatch.setattr(jax_pre, "get_library", lambda: None)
        monkeypatch.setattr(port_pre, "get_library", lambda: None)
    else:
        from dpot_tpu.native.build import native_available

        assert native_available(), "the JAX package's native library did not build"
    return request.param


def register_both(**kw):
    registry.register_dataset(registry.DatasetSpec(**kw))
    fields = {f.name for f in dataclasses.fields(jax_registry.DatasetSpec)}
    jax_registry.register_dataset(jax_registry.DatasetSpec(**{k: v for k, v in kw.items()
                                                               if k in fields}))


def synth(name, n, t_total, in_size, c):
    register_both(name=name, train_path="", test_path="", train_size=n, test_size=n,
                  scatter_storage=False, t_test=4, t_in=10, t_total=t_total,
                  in_size=in_size, n_channels=c, downsample=(1, 1), synthetic=True)


def assert_items_equal(port, jax, idx_words):
    for idx, word in idx_words:
        got, want = port.__getitem__(idx, rng=word), jax.__getitem__(idx, rng=word)
        assert len(got) == len(want) == 4
        for a, b in zip(got, want):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def words(n, seed=5):
    return list(zip(range(n), _window_words(seed, 0, 0, n)))


@pytest.mark.parametrize("train", [True, False])
def test_masked_dataset_items(host_path, train):
    synth("textra_mask_a", 3, 12, (24, 24), 2)
    synth("textra_mask_b", 2, 12, (16, 16), 3)
    kw = dict(res=16, t_in=4, t_ar=2 if train else -1, train=train, data_weights=[1, 2])
    port = MixedMaskedDataset(["textra_mask_a", "textra_mask_b"], **kw)
    jax = jax_gd.MixedMaskedDataset(["textra_mask_a", "textra_mask_b"], **kw)
    assert len(port) == len(jax) == 7 and not port.time_major_batches
    assert_items_equal(port, jax, words(len(port)))
    x_msk = port[0][0]
    assert (x_msk[:, :, -1, :] == -1.0).all()


def test_masked_dataset_batches(host_path):
    synth("textra_mask_c", 5, 12, (24, 24), 2)
    kw = dict(res=16, t_in=4, t_ar=2, train=True)
    port = MixedMaskedDataset(["textra_mask_c"], **kw)
    jax = jax_gd.MixedMaskedDataset(["textra_mask_c"], **kw)
    lkw = dict(batch_size=2, num_workers=2, seed=4, prefetch=0)
    for pb, jb in zip(DataLoader(port, **lkw), JaxLoader(jax, **lkw), strict=True):
        for a, b in zip(pb, jb):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("scatter", [True, False])
def test_steady_dataset_items(tmp_path, monkeypatch, train, scatter):
    """x -> y pairs from small HDF5 files (scatter: one file per sample;
    single: an (N, ...) array per field), resized 12x10 -> 16^2 with numpy
    and channel-padded 2 -> 3."""
    rng = np.random.default_rng(7)
    name = f"textra_steady_{int(scatter)}"
    n = 3
    xs = rng.standard_normal((n, 12, 10, 2)).astype(np.float32)
    ys = rng.standard_normal((n, 12, 10, 2)).astype(np.float32)
    split = "train" if train else "test"
    if scatter:
        import h5py

        d = tmp_path / name / split
        d.mkdir(parents=True)
        for i in range(n):
            with h5py.File(d / f"data_{i}.hdf5", "w") as f:
                f.create_dataset("x", data=xs[i])
                f.create_dataset("y", data=ys[i])
        path = f"{name}/{split}"
    else:
        write_single(str(tmp_path / f"{name}_{split}.hdf5"), xs, field="x")
        import h5py

        with h5py.File(tmp_path / f"{name}_{split}.hdf5", "a") as f:
            f.create_dataset("y", data=ys)
        path = f"{name}_{split}.hdf5"
    monkeypatch.setenv("DPOT_DATA_ROOT", str(tmp_path))
    register_both(name=name, train_path=path, test_path=path, train_size=n, test_size=n,
                  scatter_storage=scatter, t_test=1, t_in=1, t_total=1, in_size=(12, 10),
                  n_channels=2, downsample=(1, 1), pred_channels=1)
    kw = dict(res=16, n_channels=3, train=train)
    port, jax = SteadyDataset2D(name, **kw), jax_gd.SteadyDataset2D(name, **kw)
    assert len(port) == len(jax) == n
    assert_items_equal(port, jax, words(n))
    x, y, msk, _ = port[1]
    assert x.shape == y.shape == (16, 16, 1, 3) and (x[..., 2] == 1.0).all()
    gen = np.random.default_rng(0)
    a = port.shuffle_channels(x.copy(), y.copy(), gen)
    b = jax.shuffle_channels(x.copy(), y.copy(), np.random.default_rng(0))
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("train", [True, False])
def test_normalize_items_and_batches(host_path, train):
    """Per-dataset UnitTransformer stats broadcast over time; the fast paths
    and time-major batches turn off under normalize."""
    synth("textra_norm_a", 4, 12, (24, 24), 2)
    synth("textra_norm_b", 3, 12, (16, 16), 2)
    kw = dict(res=16, t_in=4, t_ar=2 if train else -1, train=train, normalize=True)
    names = ["textra_norm_a", "textra_norm_b"]
    port, jax = MixedTemporalDataset(names, **kw), jax_gd.MixedTemporalDataset(names, **kw)
    assert not port.time_major_batches and not any(port._fast_ok)
    for a, b in zip(port.normalizers, jax.normalizers):
        np.testing.assert_array_equal(a.mean, b.mean)
        np.testing.assert_array_equal(a.std, b.std)
    assert_items_equal(port, jax, words(len(port)))
    raw = MixedTemporalDataset(names, **{**kw, "normalize": False})
    assert not np.array_equal(port[0][0], raw[0][0])
    lkw = dict(batch_size=3, num_workers=2, seed=1, shuffle=train)
    for pb, jb in zip(DataLoader(port, **lkw), JaxLoader(jax, **lkw), strict=True):
        for a, b in zip(pb, jb):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_scatter_writer_feeds_time_major_datasets(tmp_path, monkeypatch, host_path):
    """A time-major 2-channel set written by the port's writer: items equal
    the JAX package's, and normalize switches its time-major batches off."""
    rng = np.random.default_rng(9)
    trajs = [rng.standard_normal((16, 16, 10, 2)).astype(np.float32) for _ in range(3)]
    write_scatter(str(tmp_path / "textra_tm"), trajs, "train", time_major=True)
    monkeypatch.setenv("DPOT_DATA_ROOT", str(tmp_path))
    register_both(name="textra_tm", train_path="textra_tm/train", test_path="textra_tm/train",
                  train_size=3, test_size=3, scatter_storage=True, t_test=4, t_in=4,
                  t_total=10, in_size=(16, 16), n_channels=2, downsample=(1, 1))
    for normalize in (False, True):
        kw = dict(res=16, t_in=4, t_ar=2, train=True, normalize=normalize)
        port = MixedTemporalDataset(["textra_tm"], **kw)
        jax = jax_gd.MixedTemporalDataset(["textra_tm"], **kw)
        assert port.time_major_batches == jax.time_major_batches == (not normalize)
        assert_items_equal(port, jax, words(3))
