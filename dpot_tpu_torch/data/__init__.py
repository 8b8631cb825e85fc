"""Data layer of the port (numpy, host side): the dataset registry,
`MixedTemporalDataset`, `TemporalDataset3D` and the threaded `DataLoader`."""

from dpot_tpu_torch.data.grid_dataset import MixedTemporalDataset, TemporalDataset3D
from dpot_tpu_torch.data.loader import DataLoader
from dpot_tpu_torch.data.registry import DATASET_DICT, DatasetSpec, register_dataset

__all__ = ["DATASET_DICT", "DataLoader", "DatasetSpec", "MixedTemporalDataset",
           "TemporalDataset3D", "register_dataset"]
