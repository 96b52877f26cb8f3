"""SincNet: a learned band-pass filterbank front end and a conv stack
(replaces ``stofnet_tpu/models/sincnet.py``; 329,859 parameters).

``SincConv`` rebuilds its mel-initialized band-pass FIR filters in f32
from two (F, 1) parameter vectors, ``low_hz_`` and ``band_hz_``, on every
forward; its kernel size is forced odd (1023) and padded by half on each
side. The driver's 4-layer stack: filters (128, 128, 128, 1), lengths
(1023, 11, 9, 7), BatchNorm (torch momentum 0.05, flax's 0.95) after each
conv, leaky-ReLU(0.2) after the first three and a linear last layer, a
(B, 1, L) heatmap at input rate. Parameter names are the reference's
(``conv.0.low_hz_``, ``conv.{i}``, ``bn.{i}``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from stofnet_tpu_torch import DeviceLike, resolve_device
from stofnet_tpu_torch.models.batchnorm import BatchNorm
from stofnet_tpu_torch.models.init import materialize
from stofnet_tpu_torch.ops.conv import conv_layer, same

BN_MOMENTUM = 0.05


class SincConv(nn.Module):
    """Parameterized sinc band-pass conv of a (B, 1, L) input, SAME
    padding: (B, L, out_channels)."""

    def __init__(self, out_channels: int = 128, kernel_size: int = 1023,
                 sample_rate: float = 16000.0, min_low_hz: float = 50.0,
                 min_band_hz: float = 50.0):
        super().__init__()
        self.out_channels = out_channels
        self.kernel_size = kernel_size + (kernel_size % 2 == 0)
        self.sample_rate = sample_rate
        self.min_low_hz, self.min_band_hz = min_low_hz, min_band_hz
        self.low_hz_ = nn.Parameter(torch.empty(out_channels, 1))
        self.band_hz_ = nn.Parameter(torch.empty(out_channels, 1))
        self.reset_parameters()

    def reset_parameters(self) -> None:
        """The mel-spaced band edges of the reference."""
        low_hz = 30.0
        high_hz = self.sample_rate / 2 - (self.min_low_hz + self.min_band_hz)
        mel = np.linspace(2595 * np.log10(1 + low_hz / 700),
                          2595 * np.log10(1 + high_hz / 700),
                          self.out_channels + 1)
        hz = 700 * (10 ** (mel / 2595) - 1)
        with torch.no_grad():
            self.low_hz_.copy_(torch.from_numpy(
                hz[:-1].reshape(-1, 1).astype(np.float32)))
            self.band_hz_.copy_(torch.from_numpy(
                np.diff(hz).reshape(-1, 1).astype(np.float32)))

    def filters(self) -> torch.Tensor:
        """The (F, 1, k) band-pass filters, in f32."""
        k, sr = self.kernel_size, self.sample_rate
        half = k // 2
        dev = self.low_hz_.device
        n_lin = np.linspace(0.0, k / 2 - 1, half)
        window = torch.from_numpy((0.54 - 0.46 * np.cos(
            2 * math.pi * n_lin / k)).astype(np.float32)).to(dev)
        n_ = torch.from_numpy((2 * math.pi * np.arange(
            -(k - 1) / 2.0, 0.0) / sr).astype(np.float32)).to(dev)[None, :]
        low = self.min_low_hz + self.low_hz_.float().abs()
        # jnp.clip's minimum(maximum(.)): a value on a bound (the top
        # filter's, at sr / 2 from the mel init) passes half its gradient,
        # where torch.clamp would pass all of it
        high = low + self.min_band_hz + self.band_hz_.float().abs()
        high = torch.minimum(torch.maximum(high, low.new_tensor(
            self.min_low_hz)), low.new_tensor(sr / 2))
        band = (high - low)[:, 0]
        f_lo, f_hi = low @ n_, high @ n_
        left = ((torch.sin(f_hi) - torch.sin(f_lo)) / (n_ / 2)) * window
        center = 2 * band[:, None]
        bp = torch.cat([left, center, left.flip(1)], dim=1)
        bp = bp / (2 * band[:, None])
        return bp.reshape(self.out_channels, 1, k)

    def forward(self, x: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        f = self.filters()
        dt = dtype or x.dtype
        y = F.conv1d(x.to(dt), f.to(dt), padding=self.kernel_size // 2)
        return y.transpose(1, 2)


class SincNet(nn.Module):
    """(B, 1, L) -> (B, 1, L) f32, the driver's 4-layer configuration."""

    def __init__(self, sample_rate: float = 16000.0,
                 n_filt: Sequence[int] = (128, 128, 128, 1),
                 len_filt: Sequence[int] = (1023, 11, 9, 7),
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        with torch.device("meta"):
            self.conv = nn.ModuleList(
                [SincConv(n_filt[0], len_filt[0], sample_rate)]
                + [nn.Conv1d(n_filt[i - 1], n_filt[i], len_filt[i])
                   for i in range(1, len(n_filt))])
            self.bn = nn.ModuleList(BatchNorm(n, BN_MOMENTUM, dtype=dtype)
                                    for n in n_filt)
        materialize(self, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = self.conv[0](x, dt)  # (B, L, F)
        h = F.leaky_relu(self.bn[0](h), 0.2)
        last = len(self.conv) - 1
        for i in range(1, last + 1):
            conv = self.conv[i]
            h = self.bn[i](conv_layer(conv, h, same(conv.kernel_size[0]), dt))
            if i < last:
                h = F.leaky_relu(h, 0.2)  # the last layer is linear
        return h.transpose(1, 2).to(torch.float32)


def rewrite_flax_key(key: str) -> str:
    """flax ``sinc_conv`` -> ``conv.0``, ``conv{i}`` -> ``conv.{i}``,
    ``bn{i}`` -> ``bn.{i}``."""
    head, rest = key.split(".", 1)
    if head == "sinc_conv":
        return "conv.0." + rest
    if head.startswith("conv") and head[4:].isdigit():
        return f"conv.{head[4:]}." + rest
    if head.startswith("bn") and head[2:].isdigit():
        return f"bn.{head[2:]}." + rest
    return key


BATCHNORM_MODULES = ("bn0", "bn1", "bn2", "bn3")
