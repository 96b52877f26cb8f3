"""Echo-bearing gate batches (replaces ``gate_batch`` of
``stofnet_tpu/data/synthetic.py``; the port's own copy)."""

from __future__ import annotations

from typing import Optional

import numpy as np


def gate_batch(batch: int, length: int, rng: np.random.Generator,
               margin: Optional[float] = None) -> np.ndarray:
    """Echo-bearing parity-gate batch, (batch, 1, length) f32: ONE
    gaussian-windowed tone echo per waveform (sigma 120 RF samples, carrier
    0.012 cycles/sample) at a random position and amplitude over a noise
    floor, max-normalized like the serving inputs. ``margin`` keeps echo
    centers away from the edges (default 500 samples, shrunk for short
    waveforms)."""
    if margin is None:
        margin = min(500.0, length / 4.0)
    t = np.arange(length, dtype=np.float32)
    x = 0.02 * rng.standard_normal((batch, length)).astype(np.float32)
    pos = rng.uniform(margin, length - margin, batch).astype(np.float32)
    amp = rng.uniform(0.3, 1.0, batch).astype(np.float32)
    for b in range(batch):
        env = np.exp(-0.5 * ((t - pos[b]) / 120.0) ** 2)
        x[b] += amp[b] * env.astype(np.float32) * np.cos(
            2 * np.pi * 0.012 * (t - pos[b]))
    x /= np.abs(x).max(axis=-1, keepdims=True)
    return x[:, None, :].astype(np.float32)
