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

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from stofnet_tpu_torch import DeviceLike, resolve_device
from stofnet_tpu_torch.models.batchnorm import BatchNorm
from stofnet_tpu_torch.models.init import materialize
from stofnet_tpu_torch.ops.conv import conv_layer, dense
from stofnet_tpu_torch.utils.stages import Stage, conv_width, run_stages

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


def _dropout(h: torch.Tensor, generator, part=None) -> torch.Tensor:
    """flax's Dropout: keep with probability 1 - rate, kept values scaled
    by 1 / (1 - rate). The keep mask is drawn from ``generator`` (a
    ``torch.Generator`` or None), or is ``generator(shape)`` where it is a
    function: masks drawn ahead of the forward, as the array step draws
    each member's (``parallel/array.py``). ``part=(lo, hi, w)``: ``h``
    holds positions lo..hi of a tensor of w, whose whole mask is drawn
    and sliced, so a length shard keeps the single process's mask."""
    keep = 1.0 - DROPOUT
    shape = h.shape if part is None else (h.shape[0], part[2], h.shape[2])
    mask = (generator(shape) if callable(generator)
            else keep_mask(shape, generator, h.device))
    if part is not None:
        mask = mask[:, part[0]:part[1]]
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

    def forward(self, x: torch.Tensor, generator=None,
                shard=None) -> torch.Tensor:
        """:meth:`stages` run by ``utils/stages.run_stages``.
        ``generator``: the dropout masks' source in train mode (see
        :func:`_dropout`). ``shard`` (``parallel/seq.Shard``): ``x`` is
        this shard's samples of each row, and every layer computes the
        shard's block of its output (:meth:`stages`)."""
        if shard is None:
            x = x[:, :, : self.input_length]
        elif shard.length != self.input_length:
            raise ValueError(f"Kuleshov shards rows of input_length="
                             f"{self.input_length}, not {shard.length}")
        return run_stages(*self.stages(generator), {"x": x}, shard)

    def stages(self, generator=None
               ) -> Tuple[List[Stage], List[Dict[str, Any]]]:
        """The forward as stages (``utils/stages``), one per layer's
        compute between fetches, with every tensor's time axis in sp
        contiguous blocks (``utils/collectives.block``), as GSPMD shards
        it: each ``fetch`` join brings a conv the input block that its
        output block reads (its taps past the block; the time concat of
        the up path's output and a skip), each stage computes its block.
        An up stage pixel-shuffles its own block, so its output is held
        ``shuffled``. BatchNorm's statistics are the sums over every block
        (``models/batchnorm.py``); each dropout mask is the whole tensor's,
        sliced by the stage's place. The dense head's contraction over the
        flattened axis is sharded: the last conv's stage multiplies its
        block by the weight's columns of its place, the ``sum`` join adds
        the partial products over the sp group, the last stage adds the
        bias. Its output ``y`` is the whole row's, on every shard. Without
        a shard the joins pass the row through: the single forward."""
        def fetch(sources, layer):
            return {"join": "fetch", "kernel": layer.kernel_size[0],
                    "stride": layer.stride[0], "write": "f", "place": "p",
                    "sources": [{"read": n, "width": w, "held": held}
                                for n, w, held in sources]}

        def block_of(layer):
            # a fetched block of n output positions: s (n - 1) + k samples
            k, s = layer.kernel_size[0], layer.stride[0]
            return (s, k - s, 1)

        def out_width(sources, layer):
            return conv_width(sum(w for _, w, _ in sources),
                              layer.kernel_size[0], layer.stride[0])

        stages = [Stage("prep", self._prep, ("x",), ("h0",), ("b1t",),
                        widths=((1, 0, 1),))]
        joins = []
        widths = [self.input_length]
        for i in range(self.num_layers):
            layer = getattr(self, f"down_conv{i}")
            src = [(f"h{i}", widths[-1], "blocks")]
            joins.append(fetch(src, layer))
            widths.append(out_width(src, layer))
            stages.append(Stage(
                f"down{i}", functools.partial(self._down, i), ("f",),
                (f"h{i + 1}",), ("btc",), (block_of(layer),),
                (f"down_conv{i}", f"down_bn{i}")))
        src = [(f"h{self.num_layers}", widths[-1], "blocks")]
        joins.append(fetch(src, self.bottleneck))
        w = out_width(src, self.bottleneck)
        stages.append(Stage(
            "bottleneck", functools.partial(self._bottleneck, generator, w),
            ("f", "p"), ("u",), ("btc", ""), (block_of(self.bottleneck), None),
            ("bottleneck",)))
        src = [("u", w, "blocks")]
        for i in range(self.num_layers):
            layer = getattr(self, f"up_conv{i}")
            joins.append(fetch(src, layer))
            w = out_width(src, layer)
            stages.append(Stage(
                f"up{i}", functools.partial(self._up, i, generator, w),
                ("f", "p"), ("u",), ("btc", ""), (block_of(layer), None),
                (f"up_conv{i}", f"up_bn{i}")))
            d = self.num_layers - i  # the skip of the concat along time
            src = [("u", 2 * w, "shuffled"), (f"h{d}", widths[d], "blocks")]
        joins.append(fetch(src, self.final_conv))
        stages.append(Stage("final", self._final, ("f", "p"), ("part",),
                            ("btc", ""), (block_of(self.final_conv), None),
                            ("final_conv", "output_fc.weight")))
        joins.append({"join": "sum", "read": "part", "write": "out"})
        stages.append(Stage("head", self._head, ("out",), ("y",), ("bc",),
                            (None,), ("output_fc.bias",)))
        return stages, joins

    def _prep(self, x):
        h = x.transpose(1, 2)
        return (h if self.dtype is None else h.to(self.dtype),)

    def _down(self, i, f):
        h = conv_layer(getattr(self, f"down_conv{i}"), f, dtype=self.dtype)
        h = F.leaky_relu(h, 0.01)
        return (F.leaky_relu(getattr(self, f"down_bn{i}")(h), 0.2),)

    def _bottleneck(self, generator, w, f, p):
        h = conv_layer(self.bottleneck, f, dtype=self.dtype)
        if self.training:
            h = _dropout(h, generator, (*p.tolist(), w))
        return (F.leaky_relu(h, 0.2),)

    def _up(self, i, generator, w, f, p):
        h = conv_layer(getattr(self, f"up_conv{i}"), f, dtype=self.dtype)
        h = getattr(self, f"up_bn{i}")(h)
        if self.training:
            h = _dropout(h, generator, (*p.tolist(), w))
        return (_pixel_shuffle_time(h),)

    def _final(self, f, p):
        dt = self.dtype
        h = conv_layer(self.final_conv, f, dtype=dt)
        lo, hi = p.tolist()
        torch._check(hi - lo == h.shape[1])
        flat = h.reshape(h.shape[0], -1)  # SubPixel1D: columns 2 lo..2 hi
        weight = self.output_fc.weight[:, 2 * lo:2 * hi]
        if dt is not None:  # the products of dt's values, summed in f32
            flat, weight = flat.to(dt).float(), weight.to(dt).float()
        return (torch.matmul(flat, weight.t()),)

    def _head(self, out):
        # dense's one rounding to dt, of the partial products' f32 sum
        bias, dt = self.output_fc.bias, self.dtype
        h = out + bias if dt is None else out.to(dt) + bias.to(dt)
        return (h[:, None, :].to(torch.float32),)


BATCHNORM_MODULES = tuple([f"down_bn{i}" for i in range(4)]
                          + [f"up_bn{i}" for i in range(4)])
