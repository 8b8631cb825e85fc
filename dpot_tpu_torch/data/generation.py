"""Offline dataset generation / preprocessing to the framework's HDF5
protocol (the port's copy of dpot_tpu/data/generation.py, numpy and h5py;
h5py is imported inside the functions, so the package imports without it).

Capability parity with reference data_generation/ (3.7k LoC of per-source
converters): the protocol is
  scatter layout: <root>/{train,test}/data_{i}.hdf5, one trajectory per
    file under key 'data', shaped (X, Y[, Z], T, C);
  single-file layout: one HDF5 with 'data' of shape (N, X, Y, T, C).
(reference data_generation/preprocess.py:58-267; the (B,T,X,Y,C) raw order
of PDEBench is transposed to (B,X,Y,T,C) at :92.)

Instead of one bespoke script per source, this module factors the
converters into: field stackers (per raw format) + `write_scatter` /
`write_single` protocol writers + a registry hook, with converters for the
PDEBench compressible-NS / SWE / diffusion-reaction raw layouts and FNO
.mat files. The files are the JAX package's byte for byte in content: either
package reads what the other writes (tests/test_torch_generation.py).
"""

from __future__ import annotations

import os
from typing import Iterable, Optional, Sequence

import numpy as np


TIME_MAJOR_ATTR = "layout"
TIME_MAJOR_TAG = "t_major"  # stored as (T, spatial..., C) instead of (spatial..., T, C)


def write_scatter(
    root: str,
    trajectories: Iterable[np.ndarray],
    split: str = "train",
    time_major: bool = False,
) -> int:
    """Write one file per trajectory: <root>/<split>/data_{i}.hdf5.

    time_major=True stores each (spatial..., T, C) trajectory transposed
    to (T, spatial..., C) and tags the dataset with layout='t_major'. A
    train item is a contiguous time window in that layout, so the ingest
    fast path reads it as ONE sequential memmap copy (the loader's
    `fetch_many_into`) and the train step undoes the transpose on the
    device."""
    import h5py

    out = os.path.join(root, split)
    os.makedirs(out, exist_ok=True)
    n = 0
    for i, traj in enumerate(trajectories):
        traj = np.asarray(traj, np.float32)
        if time_major:
            # (spatial..., T, C): >=1 spatial axes + T + C. The ndim
            # check alone can NOT distinguish channel-less (X,Y,Z,T) from
            # channeled (X,Y,T,C) — moveaxis(-2, 0) would silently move Z
            # and tag the corpus t_major, making every windowed read
            # garbage; callers must add the channel axis explicitly.
            assert traj.ndim >= 3, (
                "time_major requires channeled (spatial..., T, C) "
                f"trajectories, got shape {traj.shape} — add a trailing "
                "channel axis first (channel-less data is ambiguous here)"
            )
            traj = np.ascontiguousarray(np.moveaxis(traj, -2, 0))
        with h5py.File(os.path.join(out, f"data_{i}.hdf5"), "w") as f:
            d = f.create_dataset("data", data=traj, compression=None)
            if time_major:
                d.attrs[TIME_MAJOR_ATTR] = TIME_MAJOR_TAG
        n += 1
    return n


def write_single(path: str, data: np.ndarray, field: str = "data",
                 time_major: bool = False) -> None:
    """Write a single-file dataset with an (N, ...) 'data' array.
    time_major=True stores (N, T, spatial..., C) (see write_scatter)."""
    import h5py

    data = np.asarray(data, np.float32)
    if time_major:
        data = np.ascontiguousarray(np.moveaxis(data, -2, 1))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with h5py.File(path, "w") as f:
        d = f.create_dataset(field, data=data)
        if time_major:
            d.attrs[TIME_MAJOR_ATTR] = TIME_MAJOR_TAG


def split_train_test(n: int, test_frac: float = 0.1) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic leading/trailing split (preprocess.py:109)."""
    n_train = int((1.0 - test_frac) * n)
    return np.arange(n_train), np.arange(n_train, n)


# ---------------------------------------------------------------------------
# raw-format stackers
# ---------------------------------------------------------------------------

def stack_pdebench_ns2d(f) -> np.ndarray:
    """PDEBench 2D compressible NS: stack Vx, Vy, density, pressure and
    transpose (B, T, X, Y, C) -> (B, X, Y, T, C)
    (preprocess.py:58-92)."""
    fields = [
        np.asarray(f["Vx"], np.float32),
        np.asarray(f["Vy"], np.float32),
        np.asarray(f["density"], np.float32),
        np.asarray(f["pressure"], np.float32),
    ]
    data = np.stack(fields, axis=-1)  # B, T, X, Y, C
    return data.transpose(0, 2, 3, 1, 4)


def stack_pdebench_scalar(f, key: str = "data") -> np.ndarray:
    """PDEBench SWE / diffusion-reaction. The REAL raw corpora store one
    group per sample ('0000/data'..'0999/data', each (T, X, Y[, C]) —
    reference preprocess.py:136-141,170-175); a flat (B, T, X, Y[, C])
    'data' dataset is also accepted."""
    if key in f:
        data = np.asarray(f[key], np.float32)
    else:
        n = len(f.keys())
        data = np.stack(
            [np.asarray(f[f"{i:04d}/{key}"], np.float32) for i in range(n)],
            axis=0,
        )
    if data.ndim == 4:
        data = data[..., None]
    return data.transpose(0, 2, 3, 1, 4)


def stack_pdebench_ns3d(f) -> np.ndarray:
    """PDEBench 3D NS (B,T,X,Y,Z) -> (B,X,Y,Z,T,C). Channel order is
    [Vx, Vy, Vz, PRESSURE, DENSITY] — the reference stacks pressure
    before density for 3D (preprocess.py:233), opposite to its own 2D
    order; converted corpora must match what the released weights were
    trained on."""
    fields = [
        np.asarray(f[k], np.float32)
        for k in ["Vx", "Vy", "Vz", "pressure", "density"]
    ]
    data = np.stack(fields, axis=-1)  # B, T, X, Y, Z, C
    return data.transpose(0, 2, 3, 4, 1, 5)


def load_fno_mat(path: str, key: str = "u") -> np.ndarray:
    """Classic FNO .mat (ns2d_fno_*): (N, X, Y, T) -> (N, X, Y, T, 1)."""
    try:
        import scipy.io as sio

        raw = sio.loadmat(path)[key]
    except (NotImplementedError, ValueError):
        import h5py  # v7.3 .mat files are HDF5

        with h5py.File(path, "r") as f:
            raw = np.asarray(f[key]).transpose()  # MATLAB column order
    return np.asarray(raw, np.float32)[..., None]


def convert_pdebench(
    src_path: str,
    dst_root: str,
    kind: str = "ns2d",
    n_train: Optional[int] = None,
    n_test: Optional[int] = None,
    time_major: bool = False,
) -> tuple[int, int]:
    """End-to-end converter: raw PDEBench HDF5 -> scatter protocol
    (reference process_pdebench_data, preprocess.py:58-126).
    time_major=True emits the ingest-fast layout (see write_scatter)."""
    import h5py

    stacker = {
        "ns2d": stack_pdebench_ns2d,
        "swe": stack_pdebench_scalar,
        "dr": stack_pdebench_scalar,
        "ns3d": stack_pdebench_ns3d,
    }[kind]
    with h5py.File(src_path, "r") as f:
        data = stacker(f)
    if n_train is not None:
        # reference semantics (preprocess.py:143,178): train = the FIRST
        # n_train samples, test = the NEXT n_test — not a fixed 90/10
        n_te = n_test if n_test is not None else data.shape[0] - n_train
        train_ids = np.arange(n_train)
        test_ids = np.arange(n_train, min(n_train + n_te, data.shape[0]))
    else:
        train_ids, test_ids = split_train_test(data.shape[0])
        if n_test is not None:
            test_ids = test_ids[:n_test]
    nt = write_scatter(dst_root, (data[i] for i in train_ids), "train",
                       time_major=time_major)
    nv = write_scatter(dst_root, (data[i] for i in test_ids), "test",
                       time_major=time_major)
    return nt, nv


def convert_fno_mat(
    train_mat: str, test_mat: str, dst_train: str, dst_test: str,
    key: str = "u",
) -> None:
    """ns2d_fno_* converter: .mat pair -> two single-file HDF5 datasets."""
    write_single(dst_train, load_fno_mat(train_mat, key))
    write_single(dst_test, load_fno_mat(test_mat, key))


def generate_synthetic_corpus(
    root: str,
    name: str = "synthetic_ns2d",
    n_train: int = 32,
    n_test: int = 8,
    in_size: Sequence[int] = (64, 64),
    t_total: int = 21,
    n_channels: int = 2,
    time_major: bool = False,
) -> None:
    """Materialize a synthetic spec as an on-disk scatter dataset — lets the
    full HDF5 read path be exercised without a real corpus."""
    from dpot_tpu_torch.data.grid_dataset import _synthetic_sample
    from dpot_tpu_torch.data.registry import DatasetSpec, register_dataset

    spec = DatasetSpec(
        name=name, train_path=f"{name}/train", test_path=f"{name}/test",
        train_size=n_train, test_size=n_test, scatter_storage=True,
        t_test=max(t_total - 11, 1), t_in=10, t_total=t_total,
        in_size=tuple(in_size), n_channels=n_channels,
        downsample=(1,) * len(in_size), synthetic=True,
    )
    base = os.path.join(root, name)
    write_scatter(
        base, (_synthetic_sample(spec, True, i) for i in range(n_train)),
        "train", time_major=time_major,
    )
    write_scatter(
        base, (_synthetic_sample(spec, False, i) for i in range(n_test)),
        "test", time_major=time_major,
    )
    register_dataset(
        DatasetSpec(
            name=name, train_path=f"{name}/train", test_path=f"{name}/test",
            train_size=n_train, test_size=n_test, scatter_storage=True,
            t_test=spec.t_test, t_in=10, t_total=t_total,
            in_size=tuple(in_size), n_channels=n_channels,
            downsample=(1,) * len(in_size), synthetic=False,
        )
    )
