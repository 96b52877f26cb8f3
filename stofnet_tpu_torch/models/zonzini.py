"""Zonzini's single-echo regression CNNs (replaces
``stofnet_tpu/models/zonzini.py``).

Stages of (conv k10 stride 2 VALID -> ReLU -> max-pool k2 stride 2), a
global average pool over length and a 1024-wide dense head emitting one
ToA per frame, (B, 1). Small (134,481 parameters, chirp) and Large (PALA).
Parameter names are the reference's (``conv_layers.{i}``, ``fc1``,
``fc2``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F

from stofnet_tpu_torch import DeviceLike, resolve_device
from stofnet_tpu_torch.models.init import materialize
from stofnet_tpu_torch.ops.conv import conv_layer, dense


class _ZonziniNet(nn.Module):
    CHANNELS: Sequence[int] = ()

    def __init__(self, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        chans = (1, *self.CHANNELS)
        with torch.device("meta"):
            self.conv_layers = nn.ModuleList(
                nn.Conv1d(i, o, 10, stride=2)
                for i, o in zip(chans[:-1], chans[1:]))
            self.fc1 = nn.Linear(chans[-1], 1024)
            self.fc2 = nn.Linear(1024, 1)
        materialize(self, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, 1, L)
        dt = self.dtype
        h = x.transpose(1, 2)
        if dt is not None:
            h = h.to(dt)
        for i, conv in enumerate(self.conv_layers):
            # conv(k10, s2, VALID) emits (L-10)//2+1 and the pool needs 2
            # of those: below 12 the global pool would average nothing
            if h.shape[1] < 12:
                raise ValueError(
                    f"ZonziniNet stage {i}: length {h.shape[1]} < 12 "
                    f"(input L={x.shape[-1]} too short for "
                    f"{len(self.conv_layers)} stride-4 stages; conv+pool "
                    f"would emit width 0 and the global pool NaN)")
            h = F.relu(conv_layer(conv, h, dtype=dt))
            h = F.max_pool1d(h.transpose(1, 2), 2).transpose(1, 2)
        h = h.mean(dim=1)  # global average pool over length
        h = F.relu(dense(self.fc1, h, dt))
        return dense(self.fc2, h, dt).to(torch.float32)


class ZonziniNetSmall(_ZonziniNet):
    CHANNELS = (16, 32, 64, 64)


class ZonziniNetLarge(_ZonziniNet):
    CHANNELS = (50, 100, 150, 200, 250)


def rewrite_flax_key(key: str) -> str:
    """flax ``conv{i}`` -> torch ``conv_layers.{i}``."""
    head, rest = key.split(".", 1)
    if head.startswith("conv") and head[4:].isdigit():
        return f"conv_layers.{head[4:]}." + rest
    return key
