"""Uniform-grid temporal datasets, host side in numpy (the port's copy of
`MixedTemporalDataset` in dpot_tpu/data/grid_dataset.py).

Per sample: HDF5 read (raw_hdf5's memmap fast path, h5py otherwise) ->
bilinear resize to res^2 -> channels padded to Cmax with ONES -> train: a
random window (x = [t0, t0 + t_in), y = the next t_ar frames, an all-ones
mask) / test: the full t_test trajectory and a mask that subsamples back to
the stored resolution and zeroes padded channels. Synthetic specs generate
deterministic smooth trajectories in memory.

The port takes the numpy paths that the JAX package takes when its native
host library is not built; the batches are the same bit for bit
(tests/test_torch_data.py). The masked, steady and 3D datasets, the
`normalize=True` option and the native library wait (ROADMAP, 'Modules to
port', item 7).
"""

from __future__ import annotations

import zlib
from typing import Callable, Optional, Sequence

import numpy as np

from dpot_tpu_torch.data.raw_hdf5 import RawScatterReader, RawSingleReader, _window
from dpot_tpu_torch.data.registry import DatasetSpec, get_spec
from dpot_tpu_torch.data.resize import resize_linear_nd


def _open_sample_reader(spec: DatasetSpec, train: bool) -> Callable[..., np.ndarray]:
    """Reader for one dataset: (idx, tsel=None, copy=True) -> the raw sample
    (spatial..., T[, C]) in its stored layout, tsel restricting time."""
    if spec.synthetic:
        def read_synth(idx: int, tsel=None, copy: bool = True) -> np.ndarray:
            return _window(_synthetic_sample(spec, train, idx), tsel, n_spatial=spec.ndim)

        return read_synth
    path = spec.resolve(train)
    reader = RawScatterReader if spec.scatter_storage else RawSingleReader
    return reader(path, n_spatial=spec.ndim).read


def _synthetic_sample(spec: DatasetSpec, train: bool, idx: int) -> np.ndarray:
    """Deterministic smooth pseudo-trajectory: a low-frequency random field
    advected by a phase rotation in Fourier space. Seeded by crc32 of
    (name, split, index), so every process draws the same corpus."""
    seed = zlib.crc32(f"{spec.name}|{bool(train)}|{int(idx)}".encode()) % (2**31)
    rng = np.random.default_rng(seed)
    if len(spec.in_size) != 2:
        raise NotImplementedError(
            "3D datasets are not ported yet (ROADMAP, 'Modules to port', item 7)"
        )
    H, W = spec.in_size
    T, C = spec.t_total, spec.n_channels
    k = 6  # low-frequency modes per axis
    coef = rng.standard_normal((k, k, C)) + 1j * rng.standard_normal((k, k, C))
    omega = 2 * np.pi * rng.random((k, k, C)) * 0.05
    out = np.empty((H, W, T, C), dtype=np.float32)
    for t in range(T):
        ft = np.zeros((H, W, C), dtype=complex)
        ft[:k, :k] = coef * np.exp(1j * omega * t)
        out[..., t, :] = np.real(np.fft.ifft2(ft, axes=(0, 1))) * H
    return out


def _target_mask(x, size_orig, n_spatial: int) -> np.ndarray:
    """Ones on the stride grid that maps the padded resolution back onto the
    stored one, zeros on padded channels."""
    msk = np.zeros((*x.shape[:n_spatial], 1, x.shape[-1]), dtype=np.float32)
    strides = tuple(
        slice(None, None, max(x.shape[a] // size_orig[a], 1)) for a in range(n_spatial)
    )
    msk[strides + (slice(None), slice(None, size_orig[-1]))] = 1.0
    return msk


def _draw_start(rng, hi: int) -> int:
    """Window start from a Generator, a uint64 word (the loader's stateless
    per-item stream), a RandomState, or None (numpy's global stream)."""
    if hi <= 1:
        return 0
    if isinstance(rng, (int, np.integer)):
        return int(int(rng) % hi)
    if rng is None:
        rng = np.random
    if isinstance(rng, np.random.Generator):
        return int(rng.integers(hi))
    return int(rng.randint(hi))


def _copy_exact(dst, src):
    """np.copyto without broadcasting: an item of another shape than its
    batch slot raises instead of filling the slot by broadcast."""
    src = np.asarray(src)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(
            f"batch slot shape {tuple(dst.shape)} != item shape {tuple(src.shape)}: "
            "items with mixed shapes cannot share one batch"
        )
    np.copyto(dst, src)


def pad_data_2d(x: np.ndarray, res: int, c_max: int) -> np.ndarray:
    """(H, W, T, C) -> (res, res, T, c_max): bilinear resize, ONES channel
    padding (the numpy path of dpot_tpu/native/preprocess.py)."""
    H, W, T, C = x.shape
    if C > c_max:
        raise ValueError(
            f"sample has {C} channels > c_max={c_max}; channel TRUNCATION "
            "is not a supported conversion (slice the corpus instead)"
        )
    y = np.ascontiguousarray(x, np.float32) if (H, W) == (res, res) else \
        resize_linear_nd(x, (res, res))
    if C < c_max:
        pad = np.ones((res, res, T, c_max - C), np.float32)
        y = np.concatenate([y, pad], axis=-1)
    return y


class MixedTemporalDataset:
    """Weighted multi-dataset mixture for pretraining (reference
    utils/griddataset.py:27-174)."""

    def __init__(
        self,
        data_names: Sequence[str] | str,
        n_list: Optional[Sequence[int]] = None,
        res: int = 128,
        t_in: int = 10,
        t_ar: int = 1,
        n_channels: Optional[int] = None,
        normalize: bool = False,
        train: bool = True,
        data_weights: Optional[Sequence[int]] = None,
    ):
        if normalize:
            raise NotImplementedError(
                "dataset normalisation (utils/normalizer.py) is not ported yet "
                "(ROADMAP, 'Modules to port', item 13)"
            )
        self.data_names = [data_names] if isinstance(data_names, str) else list(data_names)
        self.specs = [get_spec(n) for n in self.data_names]
        self.data_weights = (
            list(data_weights) if data_weights is not None else [1] * len(self.specs)
        )
        self.t_in = t_in
        self.t_ar = t_ar
        self.train = train
        # every train-mode mask is all ones: the train loop then ships no mask
        self.train_masks_are_ones = bool(train)
        self.res = res
        self.n_sizes = (
            list(n_list) if n_list is not None
            else [s.train_size if train else s.test_size for s in self.specs]
        )
        weighted = [s * w for s, w in zip(self.n_sizes, self.data_weights)]
        self.cumulative_sizes = np.cumsum(weighted)
        self.t_tests = [s.t_test for s in self.specs]
        self.downsamples = [s.downsample for s in self.specs]
        self.n_channels = (
            max(s.n_channels for s in self.specs) if n_channels is None else n_channels
        )
        self.readers = [_open_sample_reader(s, train) for s in self.specs]
        # time-major corpora ((T, spatial..., C) per trajectory) window as one
        # contiguous copy; when every member is time-major and needs no
        # per-item transform, train batches ship time-major and the train
        # step moves the axis on the device (make_train_step time_major)
        self._tmaj = [
            bool(getattr(getattr(r, "__self__", None), "time_major", False))
            for r in self.readers
        ]
        self._fast_ok = [
            train
            and tuple(s.downsample) == (1, 1)
            and tuple(s.in_size) == (res, res)
            and s.n_channels == self.n_channels
            and s.t_total >= t_in + t_ar
            for s in self.specs
        ]
        self.time_major_batches = train and all(self._tmaj) and all(self._fast_ok)
        self._win_his = [s.t_total - (t_in + t_ar) + 1 for s in self.specs]

    def _std_layout(self, sample: np.ndarray, dataset_idx: int) -> np.ndarray:
        """(T, spatial..., C) -> (spatial..., T, C) for time-major corpora."""
        if self._tmaj[dataset_idx]:
            return np.moveaxis(sample, 0, -2)
        return sample

    def __len__(self) -> int:
        return int(self.cumulative_sizes[-1])

    @property
    def fast_item_shapes(self):
        """Per-item (x, y, msk) shapes of time-major batches, else None."""
        if not self.time_major_batches:
            return None
        c, r = self.n_channels, self.res
        return (self.t_in, r, r, c), (self.t_ar, r, r, c), (r, r, 1, c)

    def pad_data(self, x: np.ndarray) -> np.ndarray:
        return pad_data_2d(x, self.res, self.n_channels)

    def get_target_mask(self, x: np.ndarray, size_orig: Sequence[int]) -> np.ndarray:
        return _target_mask(x, size_orig, 2)

    def locate(self, idx: int) -> tuple[int, int]:
        """Weighted mixture indexing (griddataset.py:133-140)."""
        if len(self.specs) == 1:
            return 0, idx // self.data_weights[0]
        dataset_idx = int(np.searchsorted(self.cumulative_sizes, idx + 1))
        data_idx = idx if dataset_idx == 0 else idx - int(
            self.cumulative_sizes[dataset_idx - 1]
        )
        data_idx //= self.data_weights[dataset_idx]
        return dataset_idx, int(data_idx)

    def __getitem__(self, idx: int, rng=None):
        """(x, y, msk, cls) of item idx in the standard layout; rng draws the
        train window (see _draw_start)."""
        dataset_idx, data_idx = self.locate(idx)
        spec = self.specs[dataset_idx]
        if self.train:
            # draw the window on the raw trajectory, then read and resize
            # only its t_in + t_ar frames
            hi = max(spec.t_total - (self.t_in + self.t_ar) + 1, 1)
            start = _draw_start(rng, hi)
            win = slice(start, min(start + self.t_in + self.t_ar, spec.t_total))
            sample = np.asarray(
                self._std_layout(self.readers[dataset_idx](data_idx, tsel=win), dataset_idx),
                dtype=np.float32,
            )
            if sample.ndim == 3:
                sample = sample[..., None]
            sample = self.pad_data(sample)
            x = sample[..., : self.t_in, :]
            y = sample[..., self.t_in:, :]
            msk = np.ones((*x.shape[:2], 1, x.shape[-1]), dtype=np.float32)
        else:
            sample = np.asarray(
                self._std_layout(self.readers[dataset_idx](data_idx), dataset_idx),
                dtype=np.float32,
            )
            if sample.ndim == 3:
                sample = sample[..., None]
            orig_size = list(sample.shape)
            if spec.pred_channels is not None:
                orig_size[-1] = spec.pred_channels
            sample = self.pad_data(sample)
            x = sample[..., : self.t_in, :]
            y = sample[..., self.t_in: self.t_in + self.t_tests[dataset_idx], :]
            msk = self.get_target_mask(sample, orig_size)
        ds = self.downsamples[dataset_idx]
        if tuple(ds) != (1, 1):
            x, y = x[:: ds[0], :: ds[1]], y[:: ds[0], :: ds[1]]
        return x, y, msk, np.int32(dataset_idx)

    def fetch_into(self, idx: int, out_x, out_y, out_msk, rng) -> np.int32:
        """Item idx of a time-major batch, copied straight from the corpus into
        the batch slots (x and y time-major); the same window draw as
        __getitem__."""
        dataset_idx, data_idx = self.locate(idx)
        start = _draw_start(rng, self._win_his[dataset_idx])
        win = slice(start, start + self.t_in + self.t_ar)
        sample = self.readers[dataset_idx](data_idx, tsel=win, copy=False)
        _copy_exact(out_x, sample[: self.t_in])
        _copy_exact(out_y, sample[self.t_in:])
        if out_msk is not None:
            out_msk[...] = 1.0
        return np.int32(dataset_idx)
