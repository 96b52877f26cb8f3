"""Kuleshov's audio super-resolution U-net baseline (replaces
``stofnet_tpu/models/kuleshov.py``).

4 stride-2 VALID down convs, a stride-2 bottleneck, and 4 up stages of
(conv -> BatchNorm -> dropout -> 2x pixel shuffle -> skip concat along
*time*), closed by a k9 conv, the channel interleave (SubPixel1D) and a
dense head onto ``output_length``. The reference's quirks stay: the down
path runs leaky_relu(0.01) after the conv and leaky_relu(0.2) after the
BatchNorm; the skips concatenate along time. At the driver's chirp length
(input 8000, output 32000) the head alone is 37,936 x 32,000 and the model
has 1,248,578,050 parameters.

Dropout(0.5) draws its masks from the ``generator`` the caller passes to
``forward`` (the train step seeds one from the run's seed and the step, as
JAX folds the step into its dropout key); without one, from torch's
default generator. Parameter names are flax's, which are the reference's.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from stofnet_tpu_torch import DeviceLike, resolve_device
from stofnet_tpu_torch.models.batchnorm import BatchNorm
from stofnet_tpu_torch.models.init import materialize
from stofnet_tpu_torch.ops.conv import conv_layer, dense

N_FILTERS = (128, 256, 512, 512)
N_FILTERSIZES = (65, 33, 17, 9)
BOTTLENECK_K = 9
DROPOUT = 0.5


def conv_out_len(w: int, k: int, s: int) -> int:
    return int((w - k) / s + 1.0)


def fc_dimensions(input_length: int, num_layers: int = 4) -> int:
    """The width of the final conv's interleaved output, the dense head's
    input (reference :63-112)."""
    w = input_length
    down_widths = []
    for k in N_FILTERSIZES[:num_layers]:
        w = conv_out_len(w, k, 2)
        down_widths.append(w)
    w = conv_out_len(w, BOTTLENECK_K, 2)  # bottleneck
    for k, cd in zip(reversed(N_FILTERSIZES[:num_layers]),
                     reversed(down_widths)):
        w = conv_out_len(w, k, 1)  # up conv
        w = w * 2  # pixel shuffle doubles time
        w = w + cd  # skip concat along time
    w = conv_out_len(w, 9, 1)  # final conv
    return w * 2  # SubPixel1D interleaves the 2 channels


def _pixel_shuffle_time(h: torch.Tensor) -> torch.Tensor:
    """torch unsqueeze(2) + PixelShuffle(2) + view: (B, W, C) -> (B, 2W,
    C/2) with out[b, 2w+j, 2c+i] = h[b, w, 4c + 2i + j]."""
    b, w, c = h.shape
    h = h.reshape(b, w, c // 4, 2, 2).permute(0, 1, 4, 2, 3)
    return h.reshape(b, w * 2, c // 2)


def keep_mask(shape, generator: Optional[torch.Generator],
              device) -> torch.Tensor:
    """One dropout site's keep mask, drawn from ``generator``."""
    return torch.rand(shape, generator=generator, device=device) < (
        1.0 - DROPOUT)


def _dropout(h: torch.Tensor, generator) -> torch.Tensor:
    """flax's Dropout: keep with probability 1 - rate, kept values scaled
    by 1 / (1 - rate). The keep mask is drawn from ``generator`` (a
    ``torch.Generator`` or None), or is ``generator(shape)`` where it is a
    function: masks drawn ahead of the forward, as the array step draws
    each member's (``parallel/array.py``)."""
    keep = 1.0 - DROPOUT
    mask = (generator(h.shape) if callable(generator)
            else keep_mask(h.shape, generator, h.device))
    return torch.where(mask, h / keep, torch.zeros_like(h))


class Kuleshov(nn.Module):
    """(B, 1, L >= input_length) -> (B, 1, output_length) f32."""

    has_dropout = True
    keep_mask = staticmethod(keep_mask)

    def __init__(self, input_length: int, output_length: int,
                 num_layers: int = 4, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.input_length, self.dtype = input_length, dtype
        self.num_layers = num_layers
        cin = 1
        with torch.device("meta"):
            for i in range(num_layers):
                self.add_module(f"down_conv{i}", nn.Conv1d(
                    cin, N_FILTERS[i], N_FILTERSIZES[i], stride=2))
                self.add_module(f"down_bn{i}", BatchNorm(N_FILTERS[i],
                                                         dtype=dtype))
                cin = N_FILTERS[i]
            self.bottleneck = nn.Conv1d(cin, N_FILTERS[-1], BOTTLENECK_K,
                                        stride=2)
            cin = N_FILTERS[-1]
            up = list(zip(N_FILTERS[:num_layers],
                          N_FILTERSIZES[:num_layers]))[::-1]
            for i, (nf, fs) in enumerate(up):
                self.add_module(f"up_conv{i}", nn.Conv1d(cin, 2 * nf, fs))
                self.add_module(f"up_bn{i}", BatchNorm(2 * nf, dtype=dtype))
                cin = nf  # pixel shuffle halves the channels; the skip
                # concat is along time
            self.final_conv = nn.Conv1d(cin, 2, 9)
            self.output_fc = nn.Linear(
                fc_dimensions(input_length, num_layers), output_length)
        materialize(self, device, generator)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        """``generator``: the dropout masks' source in train mode (see
        :func:`_dropout`)."""
        dt = self.dtype
        h = x[:, :, : self.input_length].transpose(1, 2)
        if dt is not None:
            h = h.to(dt)
        skips = [h]
        for i in range(self.num_layers):
            h = conv_layer(getattr(self, f"down_conv{i}"), h, dtype=dt)
            h = F.leaky_relu(h, 0.01)
            h = F.leaky_relu(getattr(self, f"down_bn{i}")(h), 0.2)
            skips.append(h)
        h = conv_layer(self.bottleneck, h, dtype=dt)
        if self.training:
            h = _dropout(h, generator)
        h = F.leaky_relu(h, 0.2)
        for i in range(self.num_layers):
            h = conv_layer(getattr(self, f"up_conv{i}"), h, dtype=dt)
            h = getattr(self, f"up_bn{i}")(h)
            if self.training:
                h = _dropout(h, generator)
            h = _pixel_shuffle_time(h)
            h = torch.cat([h, skips[len(skips) - 1 - i]], dim=1)  # time
        h = conv_layer(self.final_conv, h, dtype=dt)
        h = h.reshape(h.shape[0], -1)  # SubPixel1D channel interleave
        h = dense(self.output_fc, h, dt)
        return h[:, None, :].to(torch.float32)


BATCHNORM_MODULES = tuple([f"down_bn{i}" for i in range(4)]
                          + [f"up_bn{i}" for i in range(4)])
