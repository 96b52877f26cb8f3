"""Tensor ops of the port (replaces ``stofnet_tpu/ops/__init__.py``)."""

from stofnet_tpu_torch.ops.conv import conv1d, conv1d_same
from stofnet_tpu_torch.ops.gaussian import gaussian_blur1d, gaussian_kernel
from stofnet_tpu_torch.ops.peaks import (
    batch_mask2coords, coords2mask, get_amplitudes, mask2coords, nms1d,
    threshold_scores,
)
from stofnet_tpu_torch.ops.poolgrad import maxpool_leaky
from stofnet_tpu_torch.ops.shuffle import sample_shuffle, sample_unshuffle

__all__ = [
    "batch_mask2coords", "conv1d", "conv1d_same", "coords2mask",
    "gaussian_blur1d", "gaussian_kernel", "get_amplitudes", "mask2coords", "maxpool_leaky", "nms1d",
    "sample_shuffle", "sample_unshuffle", "threshold_scores",
]
