"""Heatmap <-> sparse echo-coordinate decoding with static shapes
(replaces ``stofnet_tpu/ops/peaks.py``).

Detections live in a fixed ``(B, max_echoes)`` tensor: after NMS and
thresholding the ``max_echoes`` strongest survivors of each row are kept and
re-sorted by position; an empty slot is 0, the reference's padding value.

Ties: ``lax.top_k`` puts the lower index first among equal values, and
``torch.topk`` promises no order. The ranking here is a stable descending
sort, so a row with more tied survivors than slots keeps the same (lowest
index) members as the JAX decode.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def nms1d(scores: torch.Tensor, window_size: int) -> torch.Tensor:
    """Non-maximum suppression over the last axis.

    ``window_size`` is rounded up to odd. A score survives iff it equals the
    sliding-window max (ties all survive). ``max_pool1d`` pads with -inf,
    as ``reduce_window`` does in the JAX decode.
    """
    w = window_size // 2 * 2 + 1
    flat = scores.reshape(-1, 1, scores.shape[-1])
    mx = F.max_pool1d(flat, w, stride=1, padding=(w - 1) // 2)
    mx = mx.reshape(scores.shape)
    return torch.where(scores == mx, scores, torch.zeros_like(scores))


def threshold_scores(scores: torch.Tensor,
                     threshold: Optional[float | torch.Tensor] = None
                     ) -> torch.Tensor:
    """Zero out sub-threshold scores; with no/zero threshold keep only each
    row's maximum (the reference's ``if threshold:`` falsy semantics).

    A tensor threshold (0-d, or batched under ``torch.func.vmap`` over a
    threshold vector: ``parallel/array.py``'s threshold sweep) is always a
    fixed threshold, as JAX's traced one: the per-row-max mode is a
    branch on a Python value."""
    if not isinstance(threshold, torch.Tensor) and not threshold:
        threshold = scores.amax(dim=-1, keepdim=True)
    return torch.where(scores < threshold, torch.zeros_like(scores), scores)


def mask2coords(scores: torch.Tensor, window_size: int,
                threshold: Optional[float | torch.Tensor] = None,
                upsample_factor: int = 1,
                max_echoes: int = 64) -> torch.Tensor:
    """Decode a (B, L) or (B, 1, L) heatmap into per-row echo positions.

    Returns (B, max_echoes) float32 positions divided by ``upsample_factor``,
    ascending per row, zero-padded (0 = no detection).
    """
    if scores.ndim == 3:
        scores = scores.squeeze(1)
    sup = threshold_scores(nms1d(scores, window_size), threshold)

    # rank nonzero survivors above empty slots regardless of sign
    key = torch.where(sup != 0, sup, torch.full_like(sup, float("-inf")))
    vals, idx = torch.sort(key, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :max_echoes], idx[:, :max_echoes]
    valid = vals > float("-inf")

    # re-sort the selected detections by position, empty slots last
    big = scores.shape[-1] + 1
    pos = torch.where(valid, idx, torch.full_like(idx, big))
    pos = torch.sort(pos, dim=-1).values
    coords = torch.where(pos >= big, torch.zeros_like(pos), pos)
    return coords.to(torch.float32) / upsample_factor


def batch_mask2coords(scores: torch.Tensor, window_size: int,
                      threshold: Optional[float] = None,
                      upsample_factor: int = 1,
                      max_echoes: int = 64) -> torch.Tensor:
    """(B, C, L) heatmaps -> (B, C, max_echoes) per-channel coordinates."""
    b, c, length = scores.shape
    flat = mask2coords(scores.reshape(b * c, length), window_size, threshold,
                       upsample_factor, max_echoes)
    return flat.reshape(b, c, max_echoes)


def coords_to_nested_list(coords) -> list:
    """Ragged python lists of the valid (nonzero) detections of each row
    (the reference's mask2nested_list output shape; a reporting
    convenience). ``coords`` is (B, K) or (B, C, K), a tensor or an
    array."""
    if isinstance(coords, torch.Tensor):
        coords = coords.detach().cpu().numpy()
    coords = np.asarray(coords)
    if coords.ndim == 2:
        coords = coords[:, None, :]
    return [[row[row != 0].tolist() for row in frame] for frame in coords]


def coords2mask(samples: torch.Tensor, length: int) -> torch.Tensor:
    """Scatter 1s at integer sample positions -> (..., length) spike mask.

    Index 0 is the invalid slot and is forced to 0; negative positions are
    clamped to it; positions >= length are dropped.
    """
    s = samples.to(torch.int32)
    s = torch.where(s < 0, torch.zeros_like(s), s)
    grid = torch.arange(length, dtype=torch.int32, device=samples.device)
    mask = (s[..., None] == grid).any(dim=-2).to(torch.float32)
    mask[..., 0] = 0.0
    return mask


def get_amplitudes(frames: torch.Tensor,
                   samples: torch.Tensor) -> torch.Tensor:
    """Gather frame values at (rounded) sample positions along the last axis."""
    idx = torch.round(samples).to(torch.int64).clamp(0, frames.shape[-1] - 1)
    return torch.gather(frames, -1, idx)
