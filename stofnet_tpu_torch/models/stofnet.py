"""StofNet: 1-D super-resolution CNN for sub-sample echo localization
(replaces ``stofnet_tpu/models/stofnet.py``).

conv1(k9)+ReLU -> SemiGlobalBlock (80x pooled context pathway) ->
conv2..conv11 (k7, leaky-ReLU, residual add every 2nd) -> conv12 + global
residual -> conv_last(k3, features=upsample_factor) -> sample shuffle.

This is the plain PyTorch path that the port's kernels and fused forward are
held against. It keeps the JAX module's (B, L, C) layout inside and the
reference's torch parameter names (``conv1.weight``,
``semi_global_block.contract_conv.weight``, ...), so a state dict moves
between the two packages with ``models/torch_import.py``. With ``dtype``
the parameters stay f32 and are cast in the forward; each conv output and
each bias add round to ``dtype`` as in flax, and the output is f32.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F

from stofnet_tpu_torch import DeviceLike, resolve_device
from stofnet_tpu_torch.ops.conv import conv_layer, same
from stofnet_tpu_torch.ops.poolgrad import maxpool_leaky
from stofnet_tpu_torch.ops.shuffle import sample_shuffle


class SemiGlobalBlock(nn.Module):
    """80x max-pooled, channel-expanded context pathway added back onto the
    features."""

    def __init__(self, features: int, sample_scale: int = 80,
                 kernel_size: int = 5, dtype: Optional[torch.dtype] = None):
        super().__init__()
        feat = max(1, sample_scale // 10) * features
        self.sample_scale = sample_scale
        self.dtype = dtype
        self.contract_conv = nn.Conv1d(features, feat, kernel_size)
        self.expand_conv = nn.Conv1d(feat, features, kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, L, C)
        k = self.contract_conv.kernel_size[0]
        s = conv_layer(self.contract_conv, x, same(k), self.dtype)
        s = maxpool_leaky(s, self.sample_scale, 0.01)
        s = conv_layer(self.expand_conv, s, same(k), self.dtype)
        s = F.leaky_relu(s, 0.01)
        s = torch.repeat_interleave(s, self.sample_scale, dim=1)
        pad = max(0, x.shape[1] - s.shape[1])
        s = F.pad(s, (0, 0, pad // 2, pad // 2))
        if s.shape[1] != x.shape[1]:
            raise ValueError(
                f"SemiGlobalBlock length mismatch {s.shape[1]} vs {x.shape[1]}: "
                f"input length minus pooled-upsampled length must be even "
                f"(reference pads pad//2 on each side).")
        return x + s


class StofNet(nn.Module):
    """Heatmap super-resolution network; input (B, in_channels, L), output
    (B, 1, L*r) f32.

    ``generator`` re-draws every parameter from PyTorch's default Conv1d
    distribution, U(-1/sqrt(fan_in), 1/sqrt(fan_in)), on the CPU before the
    module moves to ``device``; without it the layers keep PyTorch's own
    initialisation. ``weights_init=True`` then draws the (semi-)orthogonal
    weights of the JAX module's option of that name (off by default, as
    there): gain sqrt(2) on the activation layers, 1 on the residual
    schedule's layers (conv3, conv5, ..., conv{nb-1}) and on
    ``conv_last``; biases and the SemiGlobalBlock keep their draw. The
    distribution is the JAX module's, not its bits.
    """

    def __init__(self, upsample_factor: int = 4, num_features: int = 64,
                 num_blocks: int = 13, kernel_sizes: Sequence[int] = (9, 7, 3),
                 semi_global_scale: int = 80, in_channels: int = 1,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None,
                 weights_init: bool = False, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        k1, k_mid, k_last = (int(k) for k in kernel_sizes)
        self.upsample_factor = upsample_factor
        self.num_blocks = num_blocks
        self.semi_global_scale = semi_global_scale
        self.dtype = dtype
        self.conv1 = nn.Conv1d(in_channels, num_features, k1)
        if semi_global_scale != 1:
            self.semi_global_block = SemiGlobalBlock(
                num_features, semi_global_scale, dtype=dtype)
        for i in range(2, num_blocks):
            self.add_module(f"conv{i}",
                            nn.Conv1d(num_features, num_features, k_mid))
        self.conv_last = nn.Conv1d(num_features, upsample_factor, k_last)
        if generator is not None:
            with torch.no_grad():
                for m in self.modules():
                    if isinstance(m, nn.Conv1d):
                        bound = 1.0 / math.sqrt(m.in_channels
                                                * m.kernel_size[0])
                        m.weight.uniform_(-bound, bound, generator=generator)
                        m.bias.uniform_(-bound, bound, generator=generator)
        if weights_init:
            residual = set(range(3, num_blocks - 1, 2)) | {num_blocks - 1}
            layers = [(i, getattr(self, f"conv{i}"))
                      for i in range(1, num_blocks)]
            for i, conv in layers + [(num_blocks, self.conv_last)]:
                gain = 1.0 if i in residual | {num_blocks} else math.sqrt(2)
                nn.init.orthogonal_(conv.weight, gain, generator=generator)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = x.transpose(1, 2)  # (B, L, Cin)
        if dt is not None:
            h = h.to(dt)
        # reference quirk: conv1 / conv_last paddings are hard-coded to 4 and
        # 1, "SAME" only for the default kernel sizes (9, ., 3)
        h = F.relu(conv_layer(self.conv1, h, (4, 4), dt))
        if self.semi_global_scale != 1:
            h = self.semi_global_block(h)

        # residual adds at conv{3,5,...,nb-2}; global skip into conv{nb-1}
        nb = self.num_blocks
        residual_layers = set(range(3, nb - 1, 2))
        res = res1 = h
        for i in range(2, nb - 1):
            conv = getattr(self, f"conv{i}")
            y = conv_layer(conv, h, same(conv.kernel_size[0]), dt)
            if i in residual_layers:
                h = res = res + y
            else:
                h = F.leaky_relu(y, 0.01)
        conv = getattr(self, f"conv{nb - 1}")
        h = res1 + conv_layer(conv, h, same(conv.kernel_size[0]), dt)
        h = conv_layer(self.conv_last, h, (1, 1), dt)

        out = sample_shuffle(h.transpose(1, 2), self.upsample_factor)
        return out.to(torch.float32)
