"""Gaussian kernels and 1-D blur, used to soften ground-truth spike masks
(replaces ``stofnet_tpu/ops/gaussian.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gaussian_kernel(size: int, sigma: float = 1.0,
                    dtype: torch.dtype = torch.float32,
                    device=None) -> torch.Tensor:
    """Normalized Gaussian window on the support
    ``linspace(-size//2 + 1, size//2, size)`` with numpy's floor division
    (so ``-size//2`` is ``(-size) // 2``)."""
    lo = (-size) // 2 + 1
    x = torch.linspace(lo, size // 2, size, dtype=dtype, device=device)
    k = torch.exp(-torch.square(x / sigma) / 2.0)
    return k / k.sum()


def gaussian_blur1d(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Cross-correlate (B, C, L) with a shared 1-D kernel, zero padding
    ``size//2`` on each side (``F.conv1d(x, k[None, None],
    padding=size//2)`` per channel)."""
    size = kernel.shape[0]
    b, c, length = x.shape
    k = kernel.to(device=x.device, dtype=x.dtype).reshape(1, 1, size)
    y = F.conv1d(x.reshape(b * c, 1, length), k, padding=size // 2)
    return y.reshape(b, c, -1)
