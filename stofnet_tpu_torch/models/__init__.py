"""Models of the port (replaces ``stofnet_tpu/models/__init__.py``): StofNet
with its fused forwards, the baseline zoo and the registry that the
config's ``model=`` names."""

from stofnet_tpu_torch.models.edsr1d import EDSR1D
from stofnet_tpu_torch.models.espcn1d import ESPCN1D
from stofnet_tpu_torch.models.fused import (
    stofnet_apply_fused, stofnet_apply_packed, stofnet_apply_reference,
)
from stofnet_tpu_torch.models.gradpeak import GradPeak
from stofnet_tpu_torch.models.kuleshov import Kuleshov
from stofnet_tpu_torch.models.registry import (
    MODEL_NAMES, build_model, export_checkpoint, import_checkpoint,
    variables_to_state_dict,
)
from stofnet_tpu_torch.models.sincnet import SincConv, SincNet
from stofnet_tpu_torch.models.sincnet_full import SincMLP, SincNetFull
from stofnet_tpu_torch.models.stofnet import SemiGlobalBlock, StofNet
from stofnet_tpu_torch.models.wave_unet import WaveUnet
from stofnet_tpu_torch.models.zonzini import ZonziniNetLarge, ZonziniNetSmall

__all__ = ["EDSR1D", "ESPCN1D", "GradPeak", "Kuleshov", "MODEL_NAMES",
           "SemiGlobalBlock", "SincConv", "SincMLP", "SincNet",
           "SincNetFull", "StofNet", "WaveUnet",
           "ZonziniNetLarge", "ZonziniNetSmall", "build_model",
           "export_checkpoint", "import_checkpoint", "stofnet_apply_fused",
           "stofnet_apply_packed", "stofnet_apply_reference",
           "variables_to_state_dict"]
