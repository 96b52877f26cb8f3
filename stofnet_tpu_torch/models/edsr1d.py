"""EDSR-1D, the residual super-resolution CNN baseline (replaces
``stofnet_tpu/models/edsr1d.py``; 210,289 parameters at the defaults).

conv_input(k3)+ReLU -> residual blocks (conv k3 + ReLU + conv k3, added
back) -> conv_mid + the input features -> sample shuffle x r -> conv_output
(k3, 64/r -> 1). The (B, L, C) layout inside and flax's rounding points
as ``models/stofnet.py``; the reference's parameter names
(``residual_blocks.{i}.conv1``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from stofnet_tpu_torch import DeviceLike, resolve_device
from stofnet_tpu_torch.models.init import materialize
from stofnet_tpu_torch.ops.conv import conv_layer, same
from stofnet_tpu_torch.ops.shuffle import sample_shuffle


class _ResBlock(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv1d(features, features, 3)
        self.conv2 = nn.Conv1d(features, features, 3)

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        y = F.relu(conv_layer(self.conv1, x, same(3), dtype))
        return x + conv_layer(self.conv2, y, same(3), dtype)


class EDSR1D(nn.Module):
    """(B, num_channels, L) -> (B, num_channels, L * upscale_factor) f32."""

    def __init__(self, num_channels: int = 1, num_features: int = 64,
                 num_blocks: int = 8, upscale_factor: int = 4,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.upscale_factor, self.dtype = upscale_factor, dtype
        with torch.device("meta"):
            self.conv_input = nn.Conv1d(num_channels, num_features, 3)
            self.residual_blocks = nn.ModuleList(
                _ResBlock(num_features) for _ in range(num_blocks))
            self.conv_mid = nn.Conv1d(num_features, num_features, 3)
            self.conv_output = nn.Conv1d(num_features // upscale_factor,
                                         num_channels, 3)
        materialize(self, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = x.transpose(1, 2)
        if dt is not None:
            h = h.to(dt)
        h = F.relu(conv_layer(self.conv_input, h, same(3), dt))
        res = h
        for block in self.residual_blocks:
            h = block(h, dt)
        h = conv_layer(self.conv_mid, h, same(3), dt) + res
        h = sample_shuffle(h.transpose(1, 2), self.upscale_factor)
        h = conv_layer(self.conv_output, h.transpose(1, 2), same(3), dt)
        return h.transpose(1, 2).to(torch.float32)


def reach(model: EDSR1D) -> int:
    """The largest distance, in input samples, between an output position
    and an input sample it reads: the SAME convs' half-widths at the input
    rate (conv_input, both convs of every residual block, conv_mid: 18 at
    the defaults; the residual adds reach no further), then conv_output's
    at the upsampled rate, rounded up to input samples (1)."""
    convs = [model.conv_input, model.conv_mid]
    convs += [c for b in model.residual_blocks for c in (b.conv1, b.conv2)]
    r = int(model.upscale_factor)
    last = max(same(model.conv_output.kernel_size[0]))
    return sum(max(same(c.kernel_size[0])) for c in convs) + -(-last // r)


def rewrite_flax_key(key: str) -> str:
    """flax ``residual_blocks_{i}.conv{j}`` -> torch
    ``residual_blocks.{i}.conv{j}``."""
    if key.startswith("residual_blocks_"):
        head, rest = key.split(".", 1)
        return f"residual_blocks.{head[len('residual_blocks_'):]}." + rest
    return key
