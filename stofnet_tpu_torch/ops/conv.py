"""Channels-last 1-D convolution (replaces ``conv1d_same`` of
``stofnet_tpu/ops/packed_conv.py``).

Tensors keep the JAX package's layout: activations (B, L, C), kernels
(K, Cin, Cout). With ``dtype`` the inputs, kernel and bias are cast first
and the conv output and the bias add each round to ``dtype``, as flax's
``nn.Conv(dtype=...)`` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def conv1d(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
           padding: Tuple[int, int],
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(B, L, Cin) x (K, Cin, Cout) + (Cout,) with explicit zero padding."""
    if dtype is not None:
        x, kernel, bias = x.to(dtype), kernel.to(dtype), bias.to(dtype)
    xt = F.pad(x.transpose(1, 2), padding)
    y = F.conv1d(xt, kernel.permute(2, 1, 0))
    return y.transpose(1, 2) + bias


def conv1d_same(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """flax ``padding='SAME'``: pads (k-1)//2 left and k//2 right."""
    k = kernel.shape[0]
    return conv1d(x, kernel, bias, ((k - 1) // 2, k // 2), dtype)
