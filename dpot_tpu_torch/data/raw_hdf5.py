"""Raw-offset fast path for the framework's own HDF5 protocol (the port's
copy of dpot_tpu/data/raw_hdf5.py, unchanged in behaviour).

The protocol writers (data/generation.py:write_scatter/write_single) emit
UNCOMPRESSED, CONTIGUOUS datasets. For those, h5py's generic read machinery
costs ~1 ms per call on this class of host (file open + H5Dread dispatch)
while the raw 5.5 MB page-cache read underneath is ~0.8 ms — per-sample
HDF5 overhead alone would cap ingest below the chip's consumption rate
(SURVEY §7 hard part (d); measured in tests/test_ingest_rate.py).

So: probe the dataset's byte offset ONCE with h5py (`Dataset.id.get_offset`
— None for chunked/compressed layouts), validate the file size matches
offset + nbytes exactly, then serve every subsequent read as a numpy
memmap window straight out of the page cache. Any mismatch (foreign
corpus, chunked layout, variable shapes) falls back to h5py per read.

The reference has no counterpart (torch DataLoader + h5py across 8 worker
processes, utils/griddataset.py:60-87); here a few host threads feed the
device, so per-read constant costs are the ingest budget.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import numpy as np


def contiguous_layout(path: str, field: str = "data"):
    """(byte_offset, shape, dtype) of an uncompressed contiguous HDF5
    dataset, or None when the layout can't be raw-read (chunked,
    compressed, virtual, or the offset is unavailable)."""
    import h5py

    try:
        with h5py.File(path, "r") as f:
            d = f[field]
            if d.chunks is not None or d.compression is not None:
                return None
            off = d.id.get_offset()
            if off is None:
                return None
            return int(off), tuple(d.shape), np.dtype(d.dtype)
    except Exception:
        return None


def is_time_major(path: str, field: str = "data") -> bool:
    """True when the dataset is tagged with the time-major layout attr
    (written by generation.write_scatter/write_single time_major=True:
    (T, spatial..., C) per trajectory instead of (spatial..., T, C))."""
    import h5py

    try:
        with h5py.File(path, "r") as f:
            return f[field].attrs.get("layout") == "t_major"
    except Exception:
        return False


class RawScatterReader:
    """idx -> array for scatter corpora (<root>/data_{i}.hdf5), memmapping
    files whose layout matches the probe; h5py otherwise."""

    def __init__(self, root: str, field: str = "data",
                 n_spatial: Optional[int] = None):
        self.root = root
        self.field = field
        self.n_spatial = n_spatial  # locates the time axis (see _window)
        self._layout = -1  # unprobed sentinel (None = probed, unusable)
        self._probe_size = -1  # byte size of the probed file
        self._time_major: Optional[bool] = None
        self._probe_lock = threading.Lock()  # the loader reads from a pool
        # per-file memmap cache: constructing np.memmap costs ~40-60 us
        # (mmap syscall + object setup) plus a stat for the size guard —
        # ~8% of the whole per-item ingest budget at 128^2x21x4 when paid
        # on EVERY read. Mappings are tiny (one VMA each); the cap keeps a
        # pathological 100k-file corpus under vm.max_map_count.
        self._mm_cache: dict[int, np.memmap] = {}
        self._mm_cap = 16384

    def _path(self, idx: int) -> str:
        return os.path.join(self.root, f"data_{idx}.hdf5")

    @property
    def time_major(self) -> bool:
        """Stored-layout flag (probes file 0 on first access). Readers
        return data IN THE STORED LAYOUT; callers transpose (host) or
        defer it to the device (ingest fast path)."""
        if self._time_major is None:
            self._time_major = is_time_major(self._path(0), self.field)
        return self._time_major

    def raw_mm(self, idx: int) -> Optional[np.memmap]:
        """The full trajectory memmap for file idx (cached), or None when
        the corpus can't be raw-read (chunked/compressed/foreign layout —
        the h5py fallback applies). Used directly by the loader's batched
        native assembly (grid_dataset.fetch_many_into), which needs the
        base mapping to compute raw window addresses."""
        if self._layout == -1:
            # one probe, atomically: concurrent first reads from the
            # loader's pool must not capture _layout from one file and
            # _probe_size from another (that pairing IS the safety guard).
            # _probe_size is written before _layout so an unlocked reader
            # that sees _layout set also sees its matching size.
            with self._probe_lock:
                if self._layout == -1:
                    lay = contiguous_layout(self._path(idx), self.field)
                    if lay is not None:
                        self._probe_size = os.path.getsize(self._path(idx))
                    self._layout = lay
        lay = self._layout
        if lay is None:
            return None
        m = self._mm_cache.get(idx)
        if m is None:
            path = self._path(idx)
            off, shape, dtype = lay
            nbytes = int(np.prod(shape)) * dtype.itemsize
            # size check (once per file, then the mapping is cached):
            # the probed file's own header gave (off, shape); any
            # sibling file of EXACTLY the probed byte size was written
            # identically (same writer, same shape) and is safe to
            # memmap with that layout. A different size (foreign
            # writer, shorter trajectory, variable shapes) takes the
            # h5py path.
            if (
                self._probe_size >= off + nbytes
                and os.path.getsize(path) == self._probe_size
            ):
                m = np.memmap(path, dtype=dtype, mode="r", offset=off,
                              shape=shape)
                with self._probe_lock:
                    if len(self._mm_cache) >= self._mm_cap:
                        self._mm_cache.pop(next(iter(self._mm_cache)))
                    self._mm_cache[idx] = m
        return m

    def read(self, idx: int, tsel=None, copy: bool = True) -> np.ndarray:
        """copy=False may return a memmap-backed VIEW (zero-copy — the
        caller copies straight into its destination, e.g. a batch slot);
        it is only a view on the raw fast path, so callers must not
        mutate the result."""
        tmaj = self.time_major
        m = self.raw_mm(idx)
        if m is not None:
            w = _window(m, tsel, tmaj, self.n_spatial)
            return w if not copy else np.array(w)
        path = self._path(idx)
        import h5py

        with h5py.File(path, "r") as f:
            return _window(f[self.field], tsel, tmaj, self.n_spatial)


class RawSingleReader:
    """idx -> array for single-file corpora ((N, ...) 'data' array),
    memmapping when contiguous; a cached h5py handle otherwise."""

    def __init__(self, path: str, field: str = "data",
                 n_spatial: Optional[int] = None):
        self.path = path
        self.field = field
        self.n_spatial = n_spatial  # locates the time axis (see _window)
        self._layout = -1
        self._time_major: Optional[bool] = None
        self._mm: Optional[np.memmap] = None
        self._handles: dict = {}
        self._lock = threading.Lock()  # probe/memmap/handle init races

    @property
    def time_major(self) -> bool:
        if self._time_major is None:
            self._time_major = is_time_major(self.path, self.field)
        return self._time_major

    def read(self, idx: int, tsel=None, copy: bool = True) -> np.ndarray:
        if self._layout == -1:
            with self._lock:
                if self._layout == -1:
                    self._layout = contiguous_layout(self.path, self.field)
        tmaj = self.time_major
        if self._layout is not None:
            if self._mm is None:
                with self._lock:
                    if self._mm is None:
                        off, shape, dtype = self._layout
                        self._mm = np.memmap(
                            self.path, dtype=dtype, mode="r", offset=off,
                            shape=shape,
                        )
            w = _window(self._mm[idx], tsel, tmaj, self.n_spatial)
            return w if not copy else np.array(w)
        import h5py

        # lazily open per process to be fork-safe (matches the prior
        # h5py-only reader); created under the lock so concurrent pool
        # threads don't each open (and leak) a handle
        key = os.getpid()
        h = self._handles.get(key)
        if h is None:
            with self._lock:
                h = self._handles.get(key)
                if h is None:
                    h = h5py.File(self.path, "r")
                    self._handles[key] = h
        d = h[self.field]
        if tsel is None:
            return d[idx][:]
        if tmaj:
            return d[idx, tsel]
        if self.n_spatial is not None:
            return d[(idx,) + (slice(None),) * self.n_spatial + (tsel,)]
        return d[idx, ..., tsel, :] if d.ndim >= 5 else d[idx, ..., tsel]


def _window(d, tsel, time_major: bool = False, n_spatial: Optional[int] = None):
    """Select the tsel time window: (spatial..., T[, C]) data windows the
    T axis in place; time-major (T, spatial..., C) windows the LEADING
    axis (a contiguous byte range — the whole point of that layout).

    n_spatial (the dataset's spatial rank, DatasetSpec.ndim) locates the
    time axis EXACTLY — with it, channel-less 3D (X,Y,Z,T) and channeled
    1D (X,T,C) both window T. Without it (None), fall back to the
    channel-axis heuristic (ndim>=4 ⇒ trailing C), which mis-windows
    those two layouts — callers that know their rank must pass it."""
    if tsel is None:
        return d[:]
    if time_major:
        return d[tsel]
    if n_spatial is not None:
        return d[(slice(None),) * n_spatial + (tsel,)]
    return d[..., tsel, :] if d.ndim >= 4 else d[..., tsel]
