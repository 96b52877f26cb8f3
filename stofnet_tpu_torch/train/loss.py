"""Training objectives (replaces ``stofnet_tpu/train/loss.py``): heatmap
models train on MSE against a Gaussian-blurred ground-truth spike mask plus
an L1 pull to zero; single-echo regressors on MSE to the first valid ToA.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from stofnet_tpu_torch.ops.gaussian import gaussian_blur1d, gaussian_kernel
from stofnet_tpu_torch.ops.peaks import coords2mask


def blurred_mask(gt_true: torch.Tensor, length: int,
                 kernel: torch.Tensor,
                 span: Optional[Tuple[int, int]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(unblurred spike mask, its blur), both (B, 1, length) f32.

    ``span=(start, stop)``: positions start..stop-1 of both, the values
    of the whole masks: the spike mask is built from the global positions
    over the span widened by the blur's half-width (within the row),
    blurred there, and cropped (a length shard's masks)."""
    if span is None:
        masks_true = coords2mask(gt_true, length)
        return masks_true, gaussian_blur1d(masks_true, kernel)
    start, stop = span
    half = kernel.shape[0] // 2
    lo, hi = max(0, start - half), min(length, stop + half)
    if lo == 0:
        masks = coords2mask(gt_true, hi)
    else:  # index 0 of a mask is its invalid slot: shift by one past it
        masks = coords2mask(gt_true - (lo - 1), hi - lo + 1)[..., 1:]
    blur = gaussian_blur1d(masks, kernel)
    return (masks[..., start - lo:stop - lo],
            blur[..., start - lo:stop - lo])


def heatmap_loss(
    masks_pred: torch.Tensor,
    gt_true: torch.Tensor,
    kernel: Optional[torch.Tensor] = None,
    kernel_size: int = 7,
    sigma: float = 1.0,
    mask_amplitude: float = 20.0,
    lambda_value: float = 1e-2,
    norm_max: Optional[torch.Tensor] = None,
    span: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blurred-spike MSE + lambda * L1-to-zero.

    Args:
        masks_pred: (B, 1, L_out) model heatmap.
        gt_true: (B, 1, K) integer GT positions in upsampled units (invalid
            slots <= 0).
        kernel: precomputed Gaussian kernel (else built from size/sigma).
        norm_max: the blurred mask's maximum over the full batch, for a
            micro-batch of gradient accumulation; the batch's own maximum
            when None.
        span: ``(start, length)``: ``masks_pred`` holds positions start..
            of masks of ``length`` (a length shard's heatmap).

    Returns:
        (scalar loss, (B, 1, L_out) unblurred GT spike mask; over
        ``span``, a mean over the shard's positions).
    """
    if kernel is None:
        kernel = gaussian_kernel(kernel_size, sigma)
    n = masks_pred.shape[-1]
    masks_true, blur = (
        blurred_mask(gt_true, n, kernel) if span is None
        else blurred_mask(gt_true, span[1], kernel, (span[0], span[0] + n)))
    # normalize by the GLOBAL max over the batch, then scale
    blur = blur / (blur.max() if norm_max is None else norm_max
                   ) * mask_amplitude
    mse = torch.mean(torch.square(masks_pred - blur))
    l1 = torch.mean(torch.abs(masks_pred))
    return mse + lambda_value * l1, masks_true


def first_valid_toa(gt_sample: torch.Tensor,
                    gt_true: torch.Tensor) -> torch.Tensor:
    """The earliest valid GT ToA per row: zero slots are parked at 1e12 and
    the argmin picks the smallest remaining value (first index on ties)."""
    zf = gt_true.to(torch.float32)
    z = torch.where(gt_true == 0, torch.full_like(zf, 1e12), zf)
    idx = torch.argmin(z, dim=-1, keepdim=True)
    return torch.take_along_dim(gt_sample, idx, dim=-1).to(torch.float32)


def regression_loss(pred: torch.Tensor, gt_sample: torch.Tensor,
                    gt_true: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-echo regression MSE. Returns (loss, target)."""
    target = first_valid_toa(gt_sample, gt_true)
    return torch.mean(torch.square(pred - target)), target
