"""The port's 3D data layer (dpot_tpu_torch/data/grid_dataset.py
`TemporalDataset3D`, the 3D synthetic trajectories, raw_hdf5 and the loader
at spatial rank 3) against the JAX package's: for the same specs, seed and
epoch the batches are the same bit for bit, through both loaders.

The JAX package resizes with its native host library when that is built;
the port has only the numpy path, which the JAX package takes without the
library, so the library is switched off for the JAX side here.
"""

import dataclasses

import numpy as np
import pytest

from dpot_tpu.data import DataLoader as JaxLoader
from dpot_tpu.data import TemporalDataset3D as JaxDataset3D
from dpot_tpu.data import registry as jax_registry
from dpot_tpu.data.grid_dataset import _synthetic_sample as jax_synthetic_sample
from dpot_tpu_torch.data import DataLoader, TemporalDataset3D
from dpot_tpu_torch.data import registry
from dpot_tpu_torch.data.grid_dataset import _synthetic_sample


@pytest.fixture(autouse=True)
def numpy_paths(monkeypatch):
    import dpot_tpu.native.preprocess as pre

    monkeypatch.setattr(pre, "get_library", lambda: None)


def register_both(**kw):
    spec = registry.DatasetSpec(**kw)
    registry.register_dataset(spec)
    fields = {f.name for f in dataclasses.fields(jax_registry.DatasetSpec)}
    jax_registry.register_dataset(jax_registry.DatasetSpec(**{k: v for k, v in kw.items()
                                                               if k in fields}))
    return spec


def synth3d(name, in_size, c, downsample=(1, 1, 1), pred_channels=None, t_total=9):
    return register_both(name=name, train_path="", test_path="", train_size=5, test_size=3,
                         scatter_storage=False, t_test=3, t_in=10, t_total=t_total,
                         in_size=in_size, n_channels=c, downsample=downsample,
                         pred_channels=pred_channels, synthetic=True)


def batches(loader, epochs):
    out = []
    for ep in range(epochs):
        loader.set_epoch(ep)
        out.extend(list(loader))
    return out


def assert_same(port_batches, jax_batches):
    assert len(port_batches) == len(jax_batches) > 0
    for pb, jb in zip(port_batches, jax_batches):
        assert len(pb) == len(jb) == 4
        for a, b in zip(pb, jb):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_3d_synthetic_trajectories_are_bit_identical():
    spec = synth3d("t3d_synth", (10, 8, 6), 2)
    jspec = jax_registry.get_spec("t3d_synth")
    for train, idx in ((True, 0), (False, 2)):
        got = _synthetic_sample(spec, train, idx)
        want = jax_synthetic_sample(jspec, train, idx)
        assert got.shape == (10, 8, 6, 9, 2) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


# a 12^3 set resized to 8^3, 2 channels padded to 3 with ones, one of them
# masked (pred_channels); an 8^3 set downsampled by 2
SETS = {
    "resize_pad_mask": dict(in_size=(12, 12, 12), c=2, pred_channels=1, n_channels=3),
    "downsample": dict(in_size=(8, 8, 8), c=2, downsample=(2, 2, 2), n_channels=None),
}


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("which", SETS)
def test_temporal_dataset_3d_batches_are_bit_identical(which, train):
    kw = dict(SETS[which])
    n_channels = kw.pop("n_channels")
    name = f"t3d_{which}"
    synth3d(name, **kw)
    dkw = dict(res=8, t_in=4, t_ar=2 if train else -1, n_channels=n_channels, train=train)
    port, jax = TemporalDataset3D(name, **dkw), JaxDataset3D(name, **dkw)
    assert len(port) == len(jax) == (5 if train else 3)
    assert port.train_masks_are_ones == jax.train_masks_are_ones == train
    assert port.fast_item_shapes == jax.fast_item_shapes is None
    lkw = dict(batch_size=2, shuffle=train, num_workers=2, seed=5)
    pb = batches(DataLoader(port, prefetch=2, **lkw), 2)
    assert_same(pb, batches(JaxLoader(jax, prefetch=2, **lkw), 2))
    assert_same(batches(DataLoader(port, prefetch=0, **lkw), 1),
                batches(JaxLoader(jax, prefetch=0, **lkw), 1))
    x, y, msk, cls = pb[0]
    side = 4 if which == "downsample" else 8
    assert x.shape[1:] == (side, side, side, 4, n_channels or 2) and not cls.any()
    if which == "resize_pad_mask" and not train:
        assert msk[..., 0].all() and not msk[..., 1:].any()


@pytest.mark.parametrize("time_major", [False, True])
def test_hdf5_3d_corpus_batches_are_bit_identical(tmp_path, monkeypatch, time_major):
    """A scatter HDF5 corpus of 3D trajectories written by the JAX package's
    writer (raw_hdf5 at n_spatial=3), standard and time-major: the train
    batches (time-major ones for that layout) and the test batches."""
    from dpot_tpu.data.generation import write_scatter

    rng = np.random.default_rng(0)
    trajs = [rng.standard_normal((8, 8, 8, 9, 2)).astype(np.float32) for _ in range(4)]
    name = f"t3d_h5_{int(time_major)}"
    write_scatter(str(tmp_path / name), trajs, "train", time_major=time_major)
    write_scatter(str(tmp_path / name), trajs[:2], "test", time_major=time_major)
    monkeypatch.setenv("DPOT_DATA_ROOT", str(tmp_path))
    register_both(name=name, train_path=f"{name}/train", test_path=f"{name}/test",
                  train_size=4, test_size=2, scatter_storage=True, t_test=3, t_in=10,
                  t_total=9, in_size=(8, 8, 8), n_channels=2, downsample=(1, 1, 1))
    for train in (True, False):
        kw = dict(res=8, t_in=4, t_ar=2 if train else -1, train=train)
        port, jax = TemporalDataset3D(name, **kw), JaxDataset3D(name, **kw)
        assert port.time_major_batches == jax.time_major_batches == (train and time_major)
        assert port.fast_item_shapes == jax.fast_item_shapes
        lkw = dict(batch_size=2, shuffle=train, num_workers=2, seed=3)
        assert_same(batches(DataLoader(port, **lkw), 2), batches(JaxLoader(jax, **lkw), 2))
