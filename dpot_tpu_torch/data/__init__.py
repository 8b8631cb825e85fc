"""Data layer of the port (numpy, host side): the dataset registry, the
temporal, masked, steady and 3D datasets and the threaded `DataLoader`."""

from dpot_tpu_torch.data.grid_dataset import (
    MixedMaskedDataset,
    MixedTemporalDataset,
    SteadyDataset2D,
    TemporalDataset3D,
)
from dpot_tpu_torch.data.loader import DataLoader
from dpot_tpu_torch.data.registry import DATASET_DICT, DatasetSpec, register_dataset

__all__ = ["DATASET_DICT", "DataLoader", "DatasetSpec", "MixedMaskedDataset",
           "MixedTemporalDataset", "SteadyDataset2D", "TemporalDataset3D", "register_dataset"]
