"""Data helpers of the port (replaces ``stofnet_tpu/data`` for the serving
path)."""

from stofnet_tpu_torch.data.synthetic import gate_batch

__all__ = ["gate_batch"]
