"""ESPCN-1D, the tiny sub-pixel super-resolution baseline (replaces
``stofnet_tpu/models/espcn1d.py``; 6,948 parameters).

tanh(conv1 k5) -> tanh(conv2 k3) -> conv3 k3 -> sample shuffle -> sigmoid,
with the reference's own init (``espcn1d.py:19``): weights from
normal(0, sqrt(2 / (out * k))) and zero biases, conv3's weights from
normal(0, 0.001).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from stofnet_tpu_torch import DeviceLike, resolve_device
from stofnet_tpu_torch.models.init import materialize
from stofnet_tpu_torch.ops.conv import conv_layer, same
from stofnet_tpu_torch.ops.shuffle import sample_shuffle


def espcn_init_(layer: nn.Module,
                generator: Optional[torch.Generator] = None) -> None:
    out, _, k = layer.weight.shape
    std = 0.001 if layer.in_channels == 32 else math.sqrt(2.0 / (out * k))
    layer.weight.normal_(0.0, std, generator=generator)
    layer.bias.zero_()


class ESPCN1D(nn.Module):
    """(B, 1, L) -> (B, 1, L * upscale_factor) f32."""

    def __init__(self, upscale_factor: int = 4,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.upscale_factor, self.dtype = upscale_factor, dtype
        with torch.device("meta"):
            self.conv1 = nn.Conv1d(1, 64, 5)
            self.conv2 = nn.Conv1d(64, 32, 3)
            self.conv3 = nn.Conv1d(32, upscale_factor, 3)
        materialize(self, device, generator, espcn_init_)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = x.transpose(1, 2)
        if dt is not None:
            h = h.to(dt)
        h = torch.tanh(conv_layer(self.conv1, h, same(5), dt))
        h = torch.tanh(conv_layer(self.conv2, h, same(3), dt))
        h = conv_layer(self.conv3, h, same(3), dt)
        h = sample_shuffle(h.transpose(1, 2), self.upscale_factor)
        return torch.sigmoid(h).to(torch.float32)


def reach(model: ESPCN1D) -> int:
    """The largest distance, in input samples, between an output position
    and an input sample it reads: the three SAME convs' half-widths at the
    input rate (4 at k5, k3, k3); the shuffle maps input position p onto
    outputs r p .. r p + r - 1 and reaches no further."""
    return sum(max(same(c.kernel_size[0]))
               for c in (model.conv1, model.conv2, model.conv3))
