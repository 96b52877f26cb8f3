"""Max-pool then leaky-ReLU over windows of ``scale`` samples, with a lean
backward (replaces ``stofnet_tpu/ops/poolgrad.py:maxpool_leaky``).

``leaky(maxpool(y)) == maxpool(leaky(y))`` because leaky-ReLU is monotone,
so activating the pooled tensor is exact and ``scale``x cheaper. The
backward keeps only the int32 offset of each window's first maximal
element and the sign of the pooled value, never the dense (B, L, F) input,
and routes the whole cotangent of a window to that element: a tie goes to
the first maximal element, as in the JAX op and ``torch``'s MaxPool1d
backward (``amax`` would split it evenly among the tied elements).
"""

from __future__ import annotations

import torch


def _windows(y: torch.Tensor, scale: int) -> torch.Tensor:
    """Crop L to a multiple of ``scale`` (MaxPool1d floor semantics):
    (B, L, F) -> (B, rows, scale, F)."""
    b, length, f = y.shape
    rows = length // scale
    return y[:, :rows * scale].reshape(b, rows, scale, f)


class _MaxPoolLeaky(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, scale, negative_slope):
        m, off = _windows(y, scale).max(dim=2)  # off: first maximal element
        ctx.save_for_backward(off.to(torch.int32), m >= 0)
        ctx.scale, ctx.slope, ctx.length = scale, negative_slope, y.shape[1]
        return torch.where(m >= 0, m, negative_slope * m)

    @staticmethod
    def backward(ctx, g):
        off, pos = ctx.saved_tensors
        b, rows, f = off.shape
        g_pre = torch.where(pos, g, ctx.slope * g)
        dy = g.new_zeros((b, rows, ctx.scale, f))
        dy.scatter_(2, off.long()[:, :, None, :], g_pre[:, :, None, :])
        dy = dy.reshape(b, rows * ctx.scale, f)
        if rows * ctx.scale != ctx.length:  # the cropped tail gets zero
            dy = torch.nn.functional.pad(
                dy, (0, 0, 0, ctx.length - rows * ctx.scale))
        return dy, None, None


def maxpool_leaky(y: torch.Tensor, scale: int,
                  negative_slope: float = 0.01) -> torch.Tensor:
    """(B, L, F) -> (B, L//scale, F): floor crop, window max, then leaky;
    differentiable, with the backward above."""
    return _MaxPoolLeaky.apply(y, scale, negative_slope)
