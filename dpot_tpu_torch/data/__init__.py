"""Data layer of the port (numpy, host side): the dataset registry,
`MixedTemporalDataset` and the threaded `DataLoader`."""

from dpot_tpu_torch.data.grid_dataset import MixedTemporalDataset
from dpot_tpu_torch.data.loader import DataLoader
from dpot_tpu_torch.data.registry import DATASET_DICT, DatasetSpec, register_dataset

__all__ = ["DATASET_DICT", "DataLoader", "DatasetSpec", "MixedTemporalDataset",
           "register_dataset"]
