"""Data of the port (replaces ``stofnet_tpu/data`` for the chirp path):
the stand-in generator, the chirp dataset, transforms, and the loader with
its host-to-device staging."""

from stofnet_tpu_torch.data.chirp import ChirpDataset
from stofnet_tpu_torch.data.loader import DataLoader, split_dataset
from stofnet_tpu_torch.data.synthetic import gate_batch, generate_chirp_dataset
from stofnet_tpu_torch.data.transforms import (
    AddNoise, Compose, CropChannelData, NormalizeVol,
)

__all__ = ["AddNoise", "ChirpDataset", "Compose", "CropChannelData",
           "DataLoader", "NormalizeVol", "gate_batch",
           "generate_chirp_dataset", "split_dataset"]
