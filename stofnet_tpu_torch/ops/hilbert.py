"""Analytic signal and Hilbert envelope through ``torch.fft`` (replaces
``stofnet_tpu/ops/hilbert.py``).

The reference's FFT-mask-IFFT keeps bins 0 and n//2 at weight 1 and doubles
bins 1..n//2-1, for odd n too (scipy would double bin n//2 there): the
JAX package keeps that convention, and so does this copy.
"""

from __future__ import annotations

import torch


def analytic_signal(y: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Complex analytic signal of a real waveform along ``axis``."""
    y = y.movedim(axis, -1)
    n = y.shape[-1]
    half = n // 2
    r = torch.fft.rfft(y, dim=-1)  # bins 0..n//2
    w = torch.full((half + 1,), 2.0, dtype=r.real.dtype, device=y.device)
    w[0] = w[half] = 1.0
    f = r * w
    tail = f.new_zeros(y.shape[:-1] + (n - half - 1,))
    v = torch.fft.ifft(torch.cat([f, tail], dim=-1), dim=-1)
    return v.movedim(-1, axis)


def hilbert_envelope(y: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Magnitude of the analytic signal (the instantaneous envelope)."""
    return torch.abs(analytic_signal(y, axis=axis))


def hilbert_transform_features(x: torch.Tensor, concat_oscil: bool = False,
                               channel_axis: int = 1) -> torch.Tensor:
    """Envelope features for (B, C, L) frames; with ``concat_oscil`` the raw
    oscillation is concatenated along the channel axis (the reference's
    HilbertTransform module)."""
    env = hilbert_envelope(x, axis=-1)
    if concat_oscil:
        return torch.cat([env, x], dim=channel_axis)
    return env
