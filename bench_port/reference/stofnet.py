"""StofNet's model file: its weights, its forward in plain PyTorch, float32
without TF32 (the reference that decides ``correct``), and its operations
a waveform. A configuration names it with ``"model": "stofnet"``.

Written from the published description (arXiv:2308.12009 and the
reference repository's ``stofnet.py``), on (B, C, L) tensors with
``torch.nn.functional`` convs; it imports nothing of the program.

    conv1 (k9, pad 4) + ReLU
    SemiGlobalBlock: contract conv (k5, SAME) + leaky 0.01, max-pool by
        the scale, expand conv (k5, SAME) + leaky 0.01, repeat by the
        scale, centred, added to the features
    conv2 .. conv{nb-2} (k7, SAME): leaky 0.01 after the even ones, a
        residual sum after the odd ones (conv3, conv5, ...)
    conv{nb-1} added to the SemiGlobalBlock's output (the global skip)
    conv_last (k3, pad 1) -> r channels, sample shuffle -> (B, L r)

``quant`` rounds each conv's input and weight before the f32 product: the
control computes the same forward in fp8 through it (``common.fp8``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Tuple

import torch
import torch.nn.functional as F

from bench_port.reference.common import Quant, no_tf32

SLOPE = 0.01


def layers(arch: Mapping) -> List[Tuple[str, int, int, int]]:
    """(name, cin, cout, k) of every conv of the architecture, in order."""
    c = arch["num_features"]
    k1, km, kl = arch["kernel_sizes"]
    out = [("conv1", arch["in_channels"], c, k1)]
    scale = arch["semi_global_scale"]
    if scale != 1:
        feat = max(1, scale // 10) * c
        out += [("semi_global_block.contract_conv", c, feat, 5),
                ("semi_global_block.expand_conv", feat, c, 5)]
    out += [(f"conv{i}", c, c, km) for i in range(2, arch["num_blocks"])]
    out.append(("conv_last", c, arch["upsample_factor"], kl))
    return out


def weights(cfg: Mapping, seed: int, device: torch.device
            ) -> Dict[str, torch.Tensor]:
    """The f32 state dict (the reference's torch names and layouts), drawn
    on ``device`` in one generator call and sliced in layer order: each
    conv's weight and bias from U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    PyTorch's Conv1d default."""
    shapes = []
    for name, cin, cout, k in layers(cfg["architecture"]):
        bound = 1.0 / math.sqrt(cin * k)
        shapes += [(f"{name}.weight", (cout, cin, k), bound),
                   (f"{name}.bias", (cout,), bound)]
    total = sum(math.prod(s) for _, s, _ in shapes)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    u = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    state, at = {}, 0
    for name, shape, bound in shapes:
        n = math.prod(shape)
        state[name] = ((2.0 * u[at:at + n] - 1.0) * bound).reshape(shape)
        at += n
    return state


def forward_flops(cfg: Mapping) -> float:
    """Operations of one waveform's forward at ``cfg["length"]`` samples,
    ``2 n k cin cout`` a conv over ``n`` positions: every conv at the full
    length but the SemiGlobalBlock's expand conv, on the pooled positions.
    Pools, activations, adds, the upsample and the shuffle are not
    counted."""
    arch, length = cfg["architecture"], cfg["length"]
    total = 0.0
    for name, cin, cout, k in layers(arch):
        n = (length // arch["semi_global_scale"]
             if name.endswith("expand_conv") else length)
        total += 2.0 * n * k * cin * cout
    return total


def upsample_factor(cfg: Mapping) -> int:
    return int(cfg["architecture"]["upsample_factor"])


def int8_stack_layers(cfg: Mapping) -> List[int]:
    """The stack convs conv2 .. conv{nb-1}, by index: those that the
    program's int8 route can run in s8 (``bench_port/control.py``)."""
    return list(range(2, cfg["architecture"]["num_blocks"]))


def _conv(state: Mapping[str, torch.Tensor], h: torch.Tensor, name: str,
          pad: tuple, quant: Quant) -> torch.Tensor:
    w, b = state[f"{name}.weight"].float(), state[f"{name}.bias"].float()
    if quant is not None:
        h, w = quant(h), quant(w)
    return F.conv1d(F.pad(h, pad), w) + b[:, None]


def heatmap(state: Mapping[str, torch.Tensor], x: torch.Tensor,
            cfg: Mapping, quant: Quant = None) -> torch.Tensor:
    """(B, 1, L) f32 frames -> (B, L r) f32 heatmap."""
    arch = cfg["architecture"]
    with no_tf32(), torch.no_grad():
        def conv(h, name, k):
            return _conv(state, h, name, ((k - 1) // 2, k // 2), quant)

        k1, km, kl = arch["kernel_sizes"]
        nb, r = arch["num_blocks"], arch["upsample_factor"]
        scale = arch["semi_global_scale"]
        h = F.relu(conv(x.float(), "conv1", k1))
        if scale != 1:
            s = F.leaky_relu(conv(h, "semi_global_block.contract_conv", 5),
                             SLOPE)
            s = F.max_pool1d(s, scale)
            s = F.leaky_relu(conv(s, "semi_global_block.expand_conv", 5),
                             SLOPE)
            s = torch.repeat_interleave(s, scale, dim=-1)
            pad = h.shape[-1] - s.shape[-1]
            h = h + F.pad(s, (pad // 2, pad // 2))
        res = res1 = h
        for i in range(2, nb - 1):
            y = conv(h, f"conv{i}", km)
            if i % 2:
                h = res = res + y
            else:
                h = F.leaky_relu(y, SLOPE)
        h = res1 + conv(h, f"conv{nb - 1}", km)
        h = conv(h, "conv_last", kl)  # (B, r, L)
        return h.transpose(1, 2).reshape(h.shape[0], -1)
