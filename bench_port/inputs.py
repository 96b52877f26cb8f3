"""What the benchmark makes from ``--seed`` and hands to both the program
and the plain reference, whatever the model: the frames, and the seeded
streams. The weights are the model's own (``reference/<model>.py``).

``frames`` is a frozen copy of the port's ``data/synthetic.gate_batch``
(one gaussian-windowed tone echo a waveform over a noise floor,
max-normalized), computed for all rows at once.
"""

from __future__ import annotations

import numpy as np

# independent streams drawn from one seed
STREAMS = {"frames": 1, "sample": 2}


def rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng([int(seed), STREAMS[stream]])


def frames(n: int, length: int, gen: np.random.Generator,
           margin: float = 500.0) -> np.ndarray:
    """(n, 1, length) f32 echo-bearing waveforms (``gate_batch``'s
    distribution: sigma 120 samples, carrier 0.012 cycles a sample,
    amplitude U(0.3, 1), the centre at least ``margin`` from the ends,
    noise 0.02)."""
    margin = min(margin, length / 4.0)
    t = np.arange(length, dtype=np.float32)
    x = 0.02 * gen.standard_normal((n, length), dtype=np.float32)
    pos = gen.uniform(margin, length - margin, (n, 1)).astype(np.float32)
    amp = gen.uniform(0.3, 1.0, (n, 1)).astype(np.float32)
    d = t[None, :] - pos
    x += amp * np.exp(-0.5 * (d / 120.0) ** 2) * np.cos(
        np.float32(2 * np.pi * 0.012) * d)
    x /= np.abs(x).max(axis=-1, keepdims=True)
    return x[:, None, :]
