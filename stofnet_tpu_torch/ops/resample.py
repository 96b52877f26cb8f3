"""Linear resampling and IQ->RF conversion on tensors (replaces
``stofnet_tpu/ops/resample.py``).

Target positions and carrier phases are computed on the host in numpy f64
and the fractions cast to the data's real type, as the JAX package folds
them into trace-time constants. The port's data loader keeps its own host
copy (``data/chirp.iq2rf_host``); Wave-U-Net's x2 upsample
(``align_corners=True``) uses :func:`linear_resample`.
"""

from __future__ import annotations

import numpy as np
import torch


def linear_resample(data: torch.Tensor, num_out: int,
                    axis: int = -1) -> torch.Tensor:
    """Linear interpolation of ``axis`` onto ``num_out`` points spanning the
    same support (endpoints included: linspace / interp1d semantics). A
    single point is repeated, as JAX's gather of index -1 wraps to it."""
    axis = axis % data.ndim
    n = data.shape[axis]
    t = np.linspace(0.0, n - 1.0, num_out)
    i0 = np.clip(np.floor(t).astype(np.int64), 0, max(n - 2, 0))
    real = data.real.dtype if data.is_complex() else data.dtype
    shape = [num_out] + [1] * (data.ndim - axis - 1)
    frac = torch.from_numpy((t - i0).astype(np.float32)).to(
        data.device, real).reshape(shape)
    idx = torch.from_numpy(i0).to(data.device)
    lo = data.index_select(axis, idx)
    hi = data.index_select(axis, torch.clamp(idx + 1, max=n - 1))
    return lo + (hi - lo) * frac


def upscale_1d(data: torch.Tensor, rescale_factor: float,
               axis: int = -1) -> torch.Tensor:
    """Resample to ``int(n * rescale_factor)`` points (reference
    ``upscale_1d``)."""
    return linear_resample(data, int(data.shape[axis] * rescale_factor),
                           axis=axis)


def iq2rf(iq_data: torch.Tensor, fc: float, fs: float,
          rescale_factor: float = 1) -> torch.Tensor:
    """Upscale complex IQ (time last) by ``rescale_factor`` and remodulate
    onto the carrier ``fc``; returns the real RF waveform."""
    n = iq_data.shape[-1]
    num_out = int(n * rescale_factor)
    y = linear_resample(iq_data, num_out, axis=-1)
    t = np.linspace(0.0, n / fs, num_out)
    carrier = torch.from_numpy(
        np.exp(2j * np.pi * fc * t).astype(np.complex64)).to(y.device)
    return (y * carrier).real
