"""1-D sample (pixel) shuffle (replaces ``stofnet_tpu/ops/shuffle.py``).

The sub-sample upsampler of StofNet: a reshape and a permute.
"""

from __future__ import annotations

import torch


def sample_shuffle(x: torch.Tensor, upsample_factor: int) -> torch.Tensor:
    """(B, r*C, W) -> (B, C, r*W); interleaves r channel groups along length."""
    b, rc, w = x.shape
    r = upsample_factor
    c = rc // r
    x = x.reshape(b, r, c, w).permute(0, 2, 3, 1)  # (B, C, W, r)
    return x.reshape(b, c, w * r)


def sample_unshuffle(x: torch.Tensor, upsample_factor: int) -> torch.Tensor:
    """Inverse of :func:`sample_shuffle`: (B, C, r*W) -> (B, r*C, W)."""
    b, c, wr = x.shape
    r = upsample_factor
    w = wr // r
    x = x.reshape(b, c, w, r).permute(0, 3, 1, 2)  # (B, r, C, W)
    return x.reshape(b, r * c, w)
