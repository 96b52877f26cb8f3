"""Weight initialization of the model zoo (replaces
``stofnet_tpu/models/init.py``).

The reference trains every model from torch's default module init, which
the JAX package reproduces (``stofnet_tpu/models/init.py:27,37``): weights
and biases of each conv and dense layer from U(-1/sqrt(fan_in),
1/sqrt(fan_in)), with a conv's fan_in = k * in. Here that draw comes from
an explicit ``torch.Generator``: the distribution is JAX's, not its bits.

A zoo model builds its layers on the meta device and :func:`materialize`
gives them storage on the CPU, draws them there from the generator and
moves them to the model's device, so the same seed gives the same bits on
every device and no layer is initialized twice (Kuleshov's dense head has
1.2e9 weights at the chirp length).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

Draw = Callable[[nn.Module, Optional[torch.Generator]], None]


def fan_in(layer: nn.Module) -> int:
    """Inputs per output of an ``nn.Conv1d`` (k * in) or ``nn.Linear``."""
    w = layer.weight
    return int(w.shape[1] * (w.shape[2] if w.ndim == 3 else 1))


def torch_default_(layer: nn.Module,
                   generator: Optional[torch.Generator] = None) -> None:
    """torch's default init of a conv or dense layer, drawn from
    ``generator``: weight then bias, both U(+-1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in(layer))
    layer.weight.uniform_(-bound, bound, generator=generator)
    layer.bias.uniform_(-bound, bound, generator=generator)


def materialize(model: nn.Module, device: torch.device,
                generator: Optional[torch.Generator] = None,
                draw: Draw = torch_default_) -> nn.Module:
    """Give the meta-device ``model`` storage on the CPU, initialize it
    there in module order (``draw`` for each conv and dense layer, the
    ``reset_parameters`` of any other module that has one) and move it to
    ``device``. On the meta device it stays without data."""
    if device.type == "meta":
        return model
    model.to_empty(device="cpu")
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv1d, nn.Linear)):
                draw(m, generator)
            elif m is not model and hasattr(m, "reset_parameters"):
                m.reset_parameters()
    return model.to(device)
