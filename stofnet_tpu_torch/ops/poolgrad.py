"""Max-pool then leaky-ReLU over 80-sample windows (replaces the forward of
``stofnet_tpu/ops/poolgrad.py:maxpool_leaky``).

``leaky(maxpool(y)) == maxpool(leaky(y))`` because leaky-ReLU is monotone,
so activating the pooled tensor is exact and 80x cheaper. The custom
backward of the JAX op comes with training.
"""

from __future__ import annotations

import torch


def maxpool_leaky(y: torch.Tensor, scale: int,
                  negative_slope: float = 0.01) -> torch.Tensor:
    """(B, L, F) -> (B, L//scale, F): floor crop, window max, then leaky."""
    b, length, f = y.shape
    rows = length // scale
    m = y[:, :rows * scale].reshape(b, rows, scale, f).amax(dim=2)
    return torch.where(m >= 0, m, negative_slope * m)
