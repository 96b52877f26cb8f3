"""GradPeak, the classical detector behind the model switch (replaces
``stofnet_tpu/models/gradpeak.py``).

No parameters. Returns each echo's peak position (its onset with
``onset_opt``) as a (B, max_echoes) f32 tensor, 0 = no echo, with
``echo_max`` strongest kept. Where the reference gives up on a whole batch
when one row has no candidate pairs, the row comes out all zero, as in
JAX. An ``nn.Module`` so that it moves, switches mode and saves like the
other models; ``apply(variables, x)`` is JAX's call.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from stofnet_tpu_torch import DeviceLike, resolve_device
from stofnet_tpu_torch.ops.gradpeak import toa_detect


class GradPeak(nn.Module):
    def __init__(self, threshold: Optional[float] = None,
                 rescale_factor: int = 1, echo_max: Optional[int] = None,
                 onset_opt: bool = False, max_echoes: int = 64,
                 device: DeviceLike = None):
        super().__init__()
        self.device = resolve_device(device)
        self.threshold = threshold
        self.rescale_factor = rescale_factor
        self.echo_max = echo_max
        self.onset_opt = onset_opt
        self.max_echoes = max_echoes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        frame = x.squeeze(1) if x.ndim == 3 else x
        echoes = toa_detect(frame, threshold=self.threshold,
                            rescale_factor=self.rescale_factor,
                            echo_max=self.echo_max,
                            max_echoes=self.max_echoes)
        return echoes[..., 0 if self.onset_opt else 1]

    def apply(self, _variables: Any, x: torch.Tensor, **_kw) -> torch.Tensor:
        return self(x)
