"""Models of the port (replaces ``stofnet_tpu/models/__init__.py`` for the
StofNet serving path)."""

from stofnet_tpu_torch.models.fused import (
    stofnet_apply_fused, stofnet_apply_packed, stofnet_apply_reference,
)
from stofnet_tpu_torch.models.stofnet import SemiGlobalBlock, StofNet

__all__ = ["SemiGlobalBlock", "StofNet", "stofnet_apply_fused",
           "stofnet_apply_packed", "stofnet_apply_reference"]
