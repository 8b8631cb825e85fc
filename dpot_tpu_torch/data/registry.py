"""Dataset registry (the port's copy of dpot_tpu/data/registry.py: the same
table, its own registry dict, so a spec registered here is unknown to the
JAX package and the other way round).

Typed port of the reference's DATASET_DICT table (utils/make_master_file.py:8-324):
~19 named datasets over two HDF5 storage layouts ('scatter' = one file per
sample `data_{i}.hdf5`; 'single' = one file with a `data` array). Paths are
resolved against the DPOT_DATA_ROOT env var (default ./data) instead of the
reference's hardcoded relative paths.

Additional capability over the reference: `synthetic` specs generate
deterministic pseudo-trajectories in memory — used by tests, benchmarks and
smoke training when no corpus is mounted.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    train_path: str
    test_path: str
    train_size: int
    test_size: int
    scatter_storage: bool
    t_test: int
    t_in: int
    t_total: int
    in_size: Tuple[int, ...]
    n_channels: int
    downsample: Tuple[int, ...]
    pred_channels: Optional[int] = None
    synthetic: bool = False

    @property
    def ndim(self) -> int:
        return len(self.in_size)

    def resolve(self, train: bool) -> str:
        root = os.environ.get("DPOT_DATA_ROOT", "./data")
        p = self.train_path if train else self.test_path
        return os.path.join(root, p)


DATASET_DICT: dict[str, DatasetSpec] = {}


def register_dataset(spec: DatasetSpec) -> DatasetSpec:
    DATASET_DICT[spec.name] = spec
    return spec


def _reg(name, train_path, test_path, train_size, test_size, scatter, t_test,
         t_total, in_size, n_channels, downsample=None, pred_channels=None,
         t_in=10):
    if downsample is None:
        downsample = (1,) * len(in_size)
    register_dataset(
        DatasetSpec(
            name=name, train_path=train_path, test_path=test_path,
            train_size=train_size, test_size=test_size,
            scatter_storage=scatter, t_test=t_test, t_in=t_in,
            t_total=t_total, in_size=tuple(in_size), n_channels=n_channels,
            downsample=tuple(downsample), pred_channels=pred_channels,
        )
    )


# --- classic FNO benchmarks (make_master_file.py:12-49) ---
_reg("ns2d_fno_1e-5", "large/ns2d_1e-5_train.hdf5", "large/ns2d_1e-5_test.hdf5",
     1000, 200, False, 10, 20, (64, 64), 1)
_reg("ns2d_fno_1e-4", "large/ns2d_1e-4_train.hdf5", "large/ns2d_1e-4_test.hdf5",
     9800, 200, False, 20, 30, (64, 64), 1)
_reg("ns2d_fno_1e-3", "large/ns2d_1e-3_train.hdf5", "large/ns2d_1e-3_test.hdf5",
     1000, 200, False, 20, 50, (64, 64), 1)

# --- PDEBench compressible NS 128^2 (make_master_file.py:52-105) ---
for _n in ["M1_eta1e-1_zeta1e-1", "M1_eta1e-2_zeta1e-2",
           "M1e-1_eta1e-1_zeta1e-1", "M1e-1_eta1e-2_zeta1e-2"]:
    _reg(f"ns2d_pdb_{_n}", f"large/pdebench/ns2d_pdb_{_n}/train",
         f"large/pdebench/ns2d_pdb_{_n}/test",
         9000, 200, True, 11, 21, (128, 128), 4)

# --- PDEBench 512^2 turb/rand (make_master_file.py:153-202) ---
for _n in ["M1e-1_eta1e-8_zeta1e-8_turb_512", "M1_eta1e-8_zeta1e-8_turb_512",
           "M1e-1_eta1e-8_zeta1e-8_rand_512", "M1_eta1e-8_zeta1e-8_rand_512"]:
    _reg(f"ns2d_pdb_{_n}", f"large/pdebench/ns2d_pdb_{_n}/train",
         f"large/pdebench/ns2d_pdb_{_n}/test",
         900, 20, True, 11, 21, (512, 512), 4)

# --- PDEBench 3D (make_master_file.py:204-241) ---
_reg("ns3d_pdb_M1_rand", "large/pdebench/ns3d_pdb_M1_rand/train",
     "large/pdebench/ns3d_pdb_M1_rand/test",
     90, 10, True, 11, 21, (128, 128, 128), 5)
_reg("ns3d_pdb_M1e-1_rand", "large/pdebench/ns3d_pdb_M1e-1_rand/train",
     "large/pdebench/ns3d_pdb_M1e-1_rand/test",
     90, 10, True, 11, 21, (128, 128, 128), 5)
_reg("ns3d_pdb_M1_turb", "large/pdebench/ns3d_pdb_M1_turb/train",
     "large/pdebench/ns3d_pdb_M1_turb/test",
     540, 60, True, 11, 21, (64, 64, 64), 5)

# --- shallow water / diffusion-reaction (make_master_file.py:244-267) ---
_reg("swe_pdb", "large/pdebench/swe_pdb/train", "large/pdebench/swe_pdb/test",
     900, 60, True, 91, 101, (128, 128), 1)
_reg("dr_pdb", "large/pdebench/dr_pdb/train", "large/pdebench/dr_pdb/test",
     900, 60, True, 91, 101, (128, 128), 2)

# --- CFDBench (make_master_file.py:269-282) ---
_reg("cfdbench", "large/cfdbench/ns2d_cdb_train.hdf5",
     "large/cfdbench/ns2d_cdb_test.hdf5",
     9000, 1000, False, 20, 20, (64, 64), 3, pred_channels=2)

# --- PDEArena (make_master_file.py:285-320) ---
_reg("ns2d_cond_pda", "large/pdearena/ns2d_cond_pda/train",
     "large/pdearena/ns2d_cond_pda/test",
     3100, 200, True, 46, 56, (128, 128), 3)
_reg("ns2d_pda", "large/pdearena/ns2d_pda/train", "large/pdearena/ns2d_pda/test",
     6500, 650, True, 4, 14, (128, 128), 3)
_reg("sw2d_pda", "large/pdearena/sw2d_pda/train", "large/pdearena/sw2d_pda/test",
     7000, 400, True, 78, 88, (96, 192), 5)


def make_synthetic_spec(
    name: str = "synthetic_ns2d",
    train_size: int = 32,
    test_size: int = 8,
    t_total: int = 21,
    t_test: int = 10,
    in_size: Tuple[int, ...] = (64, 64),
    n_channels: int = 2,
) -> DatasetSpec:
    """Register an in-memory synthetic dataset (tests / benchmarks)."""
    spec = DatasetSpec(
        name=name, train_path="", test_path="",
        train_size=train_size, test_size=test_size, scatter_storage=False,
        t_test=t_test, t_in=10, t_total=t_total, in_size=tuple(in_size),
        n_channels=n_channels, downsample=(1,) * len(in_size), synthetic=True,
    )
    return register_dataset(spec)


def get_spec(name: str) -> DatasetSpec:
    """Lookup with on-demand synthetic registration: any name starting with
    'synthetic' resolves to an in-memory pseudo-dataset, so CLIs and smoke
    runs work without a mounted corpus."""
    if name not in DATASET_DICT and name.startswith("synthetic"):
        return make_synthetic_spec(name)
    return DATASET_DICT[name]


def export_csv(path: str = "dataset_config.csv") -> None:
    """Dump the registry as CSV (parity with make_master_file.py:324)."""
    import csv

    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        fields = [f.name for f in dataclasses.fields(DatasetSpec)]
        w.writerow(fields)
        for spec in DATASET_DICT.values():
            w.writerow([getattr(spec, k) for k in fields])
