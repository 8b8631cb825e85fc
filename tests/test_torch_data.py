"""The port's data layer (dpot_tpu_torch/data) against the JAX package's: for
the same specs, seed and epoch, `MixedTemporalDataset` + `DataLoader` give
the same batches bit for bit.

Both packages resize with their native host library unless it is switched
off; it is switched off for both here (the native resize rounds otherwise
than numpy's; tests/test_torch_native.py and test_torch_loader_native.py
hold the port's library against the JAX package's).
"""

import dataclasses

import numpy as np
import pytest

from dpot_tpu.data import DataLoader as JaxLoader
from dpot_tpu.data import MixedTemporalDataset as JaxDataset
from dpot_tpu.data import registry as jax_registry
from dpot_tpu_torch.data import DataLoader, MixedTemporalDataset
from dpot_tpu_torch.data import registry


@pytest.fixture(autouse=True)
def numpy_paths(monkeypatch):
    import dpot_tpu.native.preprocess as pre
    import dpot_tpu_torch.native.preprocess as port_pre

    monkeypatch.setattr(pre, "get_library", lambda: None)
    monkeypatch.setattr(port_pre, "get_library", lambda: None)


def register_both(**kw):
    """The same spec in both registries."""
    spec = registry.DatasetSpec(**kw)
    registry.register_dataset(spec)
    fields = {f.name for f in dataclasses.fields(jax_registry.DatasetSpec)}
    jax_registry.register_dataset(jax_registry.DatasetSpec(**{k: v for k, v in kw.items()
                                                               if k in fields}))
    return spec


def synth(name, train, test, t_total, t_test, in_size, c):
    return register_both(name=name, train_path="", test_path="", train_size=train,
                         test_size=test, scatter_storage=False, t_test=t_test, t_in=10,
                         t_total=t_total, in_size=in_size, n_channels=c,
                         downsample=(1, 1), synthetic=True)


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


@pytest.mark.parametrize("train", [True, False])
def test_synthetic_mixture_batches_are_bit_identical(train):
    """Two synthetic specs, one resized (24^2 -> 16^2) and one channel-padded
    (2 -> 3 channels with ones), mixture weights [2, 1], two epochs."""
    synth("tdata_a", 6, 3, 14, 3, (24, 24), 2)
    synth("tdata_b", 5, 2, 14, 3, (16, 16), 3)
    kw = dict(n_list=None, res=16, t_in=4, t_ar=2 if train else -1, train=train,
              data_weights=[2, 1])
    port = MixedTemporalDataset(["tdata_a", "tdata_b"], **kw)
    jax = JaxDataset(["tdata_a", "tdata_b"], **kw)
    assert len(port) == len(jax) == (17 if train else 8)
    assert port.train_masks_are_ones == jax.train_masks_are_ones == train
    lkw = dict(batch_size=4, shuffle=train, num_workers=2, seed=7)
    assert_same(batches(DataLoader(port, prefetch=2, **lkw), 2),
                batches(JaxLoader(jax, prefetch=2, **lkw), 2))
    assert_same(batches(DataLoader(port, prefetch=0, **lkw), 1),
                batches(JaxLoader(jax, prefetch=0, **lkw), 1))


@pytest.mark.parametrize("time_major", [False, True])
def test_hdf5_corpus_batches_are_bit_identical(tmp_path, monkeypatch, time_major):
    """A scatter HDF5 corpus written by the JAX package's writer, standard
    and time-major layout: the memmap reader, and for the time-major one the
    time-major batches, match the JAX package's."""
    from dpot_tpu.data.generation import write_scatter

    rng = np.random.default_rng(0)
    trajs = [rng.standard_normal((16, 16, 12, 2)).astype(np.float32) for _ in range(6)]
    name = f"tdata_h5_{int(time_major)}"
    write_scatter(str(tmp_path / name), trajs, "train", time_major=time_major)
    write_scatter(str(tmp_path / name), trajs[:2], "test", time_major=time_major)
    monkeypatch.setenv("DPOT_DATA_ROOT", str(tmp_path))
    register_both(name=name, train_path=f"{name}/train", test_path=f"{name}/test",
                  train_size=6, test_size=2, scatter_storage=True, t_test=4, t_in=10,
                  t_total=12, in_size=(16, 16), n_channels=2, downsample=(1, 1))
    for train in (True, False):
        kw = dict(res=16, t_in=6, t_ar=2 if train else -1, train=train)
        port, jax = MixedTemporalDataset([name], **kw), JaxDataset([name], **kw)
        assert port.time_major_batches == jax.time_major_batches == (train and time_major)
        lkw = dict(batch_size=4, shuffle=train, num_workers=2, seed=3)
        assert_same(batches(DataLoader(port, **lkw), 2), batches(JaxLoader(jax, **lkw), 2))

