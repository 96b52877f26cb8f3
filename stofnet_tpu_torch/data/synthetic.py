"""Synthetic data of the port (replaces ``stofnet_tpu/data/synthetic.py``;
the port's own copy): echo-bearing gate batches, and the stand-in chirp
dataset in the stof_chirp101 on-disk format that ``data/chirp.py`` reads
(the real dataset is not in the repository).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from stofnet_tpu_torch.utils.config import dump_flat_yaml

DEFAULT_SPECS = {
    "fhz_sample": 1_000_000.0,  # IQ sample rate
    "fhz_carrier": 120_000.0,  # chirp carrier
    "temperature_celsius": 20.0,  # -> c = 343.4 m/s
}


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


def _chirp_iq(n: int, fs: float, center: float, width: float,
              bw: float = 30e3, amp: float = 1.0) -> np.ndarray:
    """Baseband gaussian-windowed linear chirp centered at sample ``center``."""
    t = (np.arange(n) - center) / fs
    env = amp * np.exp(-0.5 * (t / (width / fs)) ** 2)
    phase = np.pi * bw / (6 * width / fs) * t ** 2  # slow LFM sweep
    return env * np.exp(1j * phase)


def generate_chirp_dataset(
    root: str | Path,
    classes: Sequence[str] = ("cuboid", "cylinder"),
    n_positions: int = 4,
    n_train_per_pos: int = 3,
    n_test_per_pos: int = 1,
    sample_num: int = 800,
    seed: int = 3008,
    specs: Optional[dict] = None,
) -> Path:
    """Write the stand-in dataset under ``root``: per class, train, test
    and truth measurements (envelope and IQ text files) of chirp echoes at
    known distances, the distances in ``truth/true_measurement_positions
    .csv``, and ``sensor_specs.yaml``. The same arguments write the same
    bytes as the JAX package's generator. Returns the root path."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    specs = dict(DEFAULT_SPECS, **(specs or {}))
    (root / "sensor_specs.yaml").write_text(dump_flat_yaml(specs))

    fs = specs["fhz_sample"]
    c = 331.4 + 0.6 * specs["temperature_celsius"]
    rng = np.random.default_rng(seed)

    # positions such that the round-trip ToF lands inside the window
    max_d = 0.8 * sample_num / fs * c / 2 * 1e3  # mm
    positions = np.linspace(0.25 * max_d, max_d, n_positions)

    def write_measurement(path: Path, stem: str, pos_mm: float, noisy: bool):
        toa_samples = 2 * (pos_mm * 1e-3) / c * fs
        amp = 1.0 / (1.0 + (pos_mm / max_d))
        iq = _chirp_iq(sample_num, fs, toa_samples, width=12.0, amp=amp)
        if noisy:
            jitter = rng.normal(0, 0.35)
            iq = _chirp_iq(sample_num, fs, toa_samples + jitter, width=12.0,
                           amp=amp * rng.uniform(0.8, 1.2))
            iq = iq + 0.02 * (rng.standard_normal(sample_num)
                              + 1j * rng.standard_normal(sample_num))
        env = np.abs(iq)
        np.savetxt(path / f"{stem}_envelope.txt", env)
        np.savetxt(path / f"{stem}_iq.txt", np.c_[iq.real, iq.imag])

    for ci, cls in enumerate(classes):
        cdir = root / cls
        truth = cdir / "truth"
        # per-class distance offset so classes differ
        cls_positions = positions * (1.0 + 0.05 * ci)
        rows = []
        for pi, pos in enumerate(cls_positions):
            seq = truth / f"meas_{pi}"
            seq.mkdir(parents=True, exist_ok=True)
            write_measurement(seq, f"truth_{pi}", pos, noisy=False)
            rows.append((pi, pos))
            for split, count in (("train", n_train_per_pos),
                                 ("test", n_test_per_pos)):
                for mi in range(count):
                    seq = cdir / split / f"meas_{pi}_{mi}"
                    seq.mkdir(parents=True, exist_ok=True)
                    write_measurement(seq, f"sample_{pi}_{mi}", pos, noisy=True)
        np.savetxt(truth / "true_measurement_positions.csv",
                   np.asarray(rows), delimiter=",")
    return root
