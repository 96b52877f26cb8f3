"""Wave-U-Net, the denoising U-net at input rate (replaces
``stofnet_tpu/models/wave_unet.py``; n_layers=2, channels 16 on chirp:
37,762 parameters).

Encoder blocks of (conv k15 SAME -> BatchNorm -> leaky 0.1) with stride-2
downsampling by slicing, a middle block, decoder blocks of (linear x2
upsample, ``align_corners=True`` -> skip concat on channels -> conv k5
SAME -> BatchNorm -> leaky 0.1), and a k1 conv + tanh over [features,
input]. The driver folds the upsample factor into ``rf_scale_factor``.
Parameter names are the reference's (``encoder.{i}.main.{0|1}``,
``middle.{0|1}``, ``decoder.{i}.main.{0|1}``, ``out.0``); BatchNorm has
flax's semantics (``models/batchnorm.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from stofnet_tpu_torch import DeviceLike, resolve_device
from stofnet_tpu_torch.models.batchnorm import BatchNorm
from stofnet_tpu_torch.models.init import materialize
from stofnet_tpu_torch.ops.conv import conv_layer, same
from stofnet_tpu_torch.ops.resample import linear_resample


def _block(cin: int, cout: int, k: int, dtype) -> nn.Sequential:
    return nn.Sequential(nn.Conv1d(cin, cout, k), BatchNorm(cout, dtype=dtype))


class _Main(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, dtype):
        super().__init__()
        self.main = _block(cin, cout, k, dtype)


def _run(block: nn.Sequential, h: torch.Tensor, dtype) -> torch.Tensor:
    conv, bn = block
    h = conv_layer(conv, h, same(conv.kernel_size[0]), dtype)
    return F.leaky_relu(bn(h), 0.1)


class WaveUnet(nn.Module):
    """(B, 1, L) -> (B, 1, L) f32; L a multiple of 2**n_layers."""

    def __init__(self, n_layers: int = 2, channels_interval: int = 16,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.n_layers, self.dtype = n_layers, dtype
        ci = channels_interval
        enc_out = [(i + 1) * ci for i in range(n_layers)]
        enc_in = [1] + enc_out[:-1]
        dec_out = enc_out[::-1]
        # the upsampled features (the middle's, then the last decoder's)
        # concatenated with the skip of the same depth
        dec_in = [a + b for a, b in zip([enc_out[-1]] + dec_out[:-1],
                                        enc_out[::-1])]
        with torch.device("meta"):
            self.encoder = nn.ModuleList(
                _Main(i, o, 15, dtype) for i, o in zip(enc_in, enc_out))
            self.middle = _block(n_layers * ci, n_layers * ci, 15, dtype)
            self.decoder = nn.ModuleList(
                _Main(i, o, 5, dtype) for i, o in zip(dec_in, dec_out))
            self.out = nn.Sequential(nn.Conv1d(ci + 1, 1, 1))
        materialize(self, device, generator)

    def forward(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        """``shard`` (``parallel/seq.Shard``): ``x`` is the window
        ``shard.window`` of a row of ``shard.length`` samples, its start on
        the grid of ``2 ** n_layers`` (so ``h[:, ::2]`` keeps the global
        even positions), and each x2 resample runs on the global grid."""
        dt = self.dtype
        start, length = ((0, x.shape[-1]) if shard is None
                         else (shard.window[0], shard.length))
        h = x.transpose(1, 2)  # (B, L, 1)
        if dt is not None:
            h = h.to(dt)
        inp = h
        skips = []
        for enc in self.encoder:
            h = _run(enc.main, h, dt)
            skips.append(h)
            h = h[:, ::2, :]  # stride 2 by slicing
        h = _run(self.middle, h, dt)
        for i, dec in enumerate(self.decoder):
            lv = self.n_layers - 1 - i  # the level it upsamples onto
            grid = None if shard is None else (
                length >> (lv + 1), length >> lv, start >> (lv + 1),
                start >> lv)
            h = linear_resample(h, h.shape[1] * 2, axis=1, window=grid)
            h = torch.cat([h, skips[self.n_layers - i - 1]], dim=-1)
            h = _run(dec.main, h, dt)
        h = torch.cat([h, inp], dim=-1)
        h = torch.tanh(conv_layer(self.out[0], h, dtype=dt))
        return h.transpose(1, 2).to(torch.float32)


def reach(model: WaveUnet) -> int:
    """The largest distance, in input samples, between an output position
    and an input sample it reads, and the window's alignment: level i
    (after i decimations) holds input positions ``2**i p``. Each encoder
    conv reaches its half-width at its level's scale, the middle conv at
    ``2**n``, each decoder its resample (one position at the level below)
    and its conv's half-width at its own level; a shard's first position
    rounds to its level's grid, at most ``2**n`` samples. 65 samples at
    two layers; at PALA's ten it exceeds a 10240-sample row, whose window
    is then the whole row."""
    n = int(model.n_layers)
    out = sum(max(same(e.main[0].kernel_size[0])) << i
              for i, e in enumerate(model.encoder))
    out += max(same(model.middle[0].kernel_size[0])) << n
    for i, d in enumerate(model.decoder):
        lv = n - 1 - i
        out += (1 << (lv + 1)) + (max(same(d.main[0].kernel_size[0])) << lv)
    return out + (1 << n)


def rewrite_flax_key(key: str) -> str:
    """flax ``enc{i}_{conv|bn}``, ``middle_*``, ``dec{i}_*``, ``out_conv``
    -> the reference's torch names."""
    head, rest = key.split(".", 1)
    sub = {"conv": "0", "bn": "1"}
    if head == "out_conv":
        return "out.0." + rest
    if "_" in head:
        mod, kind = head.rsplit("_", 1)
        if kind in sub:
            if mod == "middle":
                return f"middle.{sub[kind]}." + rest
            if mod.startswith("enc"):
                return f"encoder.{mod[3:]}.main.{sub[kind]}." + rest
            if mod.startswith("dec"):
                return f"decoder.{mod[3:]}.main.{sub[kind]}." + rest
    return key


def batchnorm_modules(n_layers: int) -> Tuple[str, ...]:
    """The flax names of the BatchNorm modules at depth ``n_layers``."""
    return tuple([f"enc{i}_bn" for i in range(n_layers)] + ["middle_bn"]
                 + [f"dec{i}_bn" for i in range(n_layers)])
