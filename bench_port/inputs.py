"""What the benchmark makes from ``--seed`` and hands to both the program
and the plain reference: the frames and the weights.

``frames`` is a frozen copy of the port's ``data/synthetic.gate_batch``
(one gaussian-windowed tone echo a waveform over a noise floor,
max-normalized), computed for all rows at once. ``weights`` draws a
StofNet state dict (the reference's torch names and layouts) on the
device from one generator call: each conv's weight and bias from
U(-1/sqrt(fan_in), 1/sqrt(fan_in)), PyTorch's Conv1d default.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

# independent streams drawn from one seed
STREAMS = {"frames": 1, "sample": 2}


def rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng([int(seed), STREAMS[stream]])


def frames(n: int, length: int, gen: np.random.Generator,
           margin: float = 500.0) -> np.ndarray:
    """(n, 1, length) f32 echo-bearing waveforms (``gate_batch``'s
    distribution: sigma 120 samples, carrier 0.012 cycles a sample,
    amplitude U(0.3, 1), the centre at least ``margin`` from the ends,
    noise 0.02)."""
    margin = min(margin, length / 4.0)
    t = np.arange(length, dtype=np.float32)
    x = 0.02 * gen.standard_normal((n, length), dtype=np.float32)
    pos = gen.uniform(margin, length - margin, (n, 1)).astype(np.float32)
    amp = gen.uniform(0.3, 1.0, (n, 1)).astype(np.float32)
    d = t[None, :] - pos
    x += amp * np.exp(-0.5 * (d / 120.0) ** 2) * np.cos(
        np.float32(2 * np.pi * 0.012) * d)
    x /= np.abs(x).max(axis=-1, keepdims=True)
    return x[:, None, :]


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


def weights(arch: Mapping, seed: int, device: torch.device
            ) -> Dict[str, torch.Tensor]:
    """The f32 state dict, drawn on ``device`` in one call."""
    shapes = []
    for name, cin, cout, k in layers(arch):
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
