"""stof_chirp101-format dataset (the port's own copy of
``stofnet_tpu/data/chirp.py``; ``sensor_specs.yaml`` is read by the port's
flat-YAML reader, not PyYAML).

Directory contract::

    root/
      sensor_specs.yaml        # fhz_sample, fhz_carrier, temperature_celsius
      <class>/                 # one dir per measured object
        train/<seq>/*envelope*.txt, *iq*.txt
        test/<seq>/...
        truth/<seq>/*envelope*.txt, *iq*.txt
        truth/true_measurement_positions.csv   # col 1 = position [mm]

Each item: envelope + complex IQ measurement, the class's ground-truth IQ,
and the GT position converted to a (fractional) sample index via round-trip
time of flight at the temperature-derived speed of sound
(331.4 + 0.6 * T degC). IQ is upsampled by ``rf_scale_factor`` and
remodulated onto the carrier in host numpy, so loader threads prefetch it.
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import List, Tuple

import numpy as np

from stofnet_tpu_torch.native import loadtxt  # C++ fast path, python fallback
from stofnet_tpu_torch.utils.config import read_flat_yaml
from stofnet_tpu_torch.utils.natsort import natsorted


def upscale_1d(data: np.ndarray, rescale_factor: float, fs: float = 1.0):
    n = data.shape[0]
    x = np.linspace(0, n / fs, num=n, endpoint=True)
    t = np.linspace(0, n / fs, num=int(n * rescale_factor), endpoint=True)
    return np.interp(t, x, data) if not np.iscomplexobj(data) else (
        np.interp(t, x, data.real) + 1j * np.interp(t, x, data.imag))


def iq2rf_host(iq: np.ndarray, fc: float, fs: float, rescale_factor: float):
    n = iq.shape[0]
    x = np.linspace(0, n / fs, num=n, endpoint=True)
    t = np.linspace(0, n / fs, num=int(n * rescale_factor), endpoint=True)
    y = np.interp(t, x, iq.real) + 1j * np.interp(t, x, iq.imag)
    return (y * np.exp(2j * np.pi * fc * t)).real


class ChirpDataset:
    def __init__(self, root_dir, split_dirname: str = "test",
                 rf_scale_factor: int = 10, transforms=None, seed: int = 0):
        self.root_dir = Path(root_dir)
        self.split_dirname = split_dirname
        self.rf_scale_factor = rf_scale_factor
        self.transforms = transforms
        # per-call augmentation rng = f(seed, item, per-item draw #):
        # thread-safe under the thread-pool loader (a shared Generator is
        # not), different each epoch, and order-independent: item idx's
        # n-th draw always seeds (seed, idx, n) whichever thread serves it
        self._seed = int(seed)
        self._draw_lock = threading.Lock()
        self._draws: dict = {}

        specs = self.root_dir / "sensor_specs.yaml"
        self.cfg = read_flat_yaml(specs.read_text(), str(specs))
        self.cfg["speed_of_sound"] = 331.4 + 0.6 * self.cfg["temperature_celsius"]

        self.samples_env: List[Path] = []
        self.samples_iq: List[Path] = []
        self.gt_iq: List[Path] = []
        self.gt_positions: List[float] = []
        self.labels: List[str] = []

        for target_dir in sorted(d for d in self.root_dir.iterdir() if d.is_dir()):
            env_paths, iq_paths = self._scan(target_dir / split_dirname)
            self.samples_env.extend(env_paths)
            self.samples_iq.extend(iq_paths)

            _, gt_iq = self._scan(target_dir / "truth")
            positions = loadtxt(
                target_dir / "truth" / "true_measurement_positions.csv")[:, 1]

            rep = len(iq_paths) // max(len(gt_iq), 1)
            self.gt_iq.extend(p for p in gt_iq for _ in range(rep))
            self.gt_positions.extend(float(p) for p in positions
                                     for _ in range(rep))
            self.labels.extend([target_dir.name] * len(iq_paths))

        if not (len(self.samples_env) == len(self.samples_iq)
                == len(self.gt_iq) == len(self.gt_positions)
                == len(self.labels)):
            raise ValueError(f"{self.root_dir}: inconsistent sample counts")

    @staticmethod
    def _scan(split_dir: Path) -> Tuple[List[Path], List[Path]]:
        env, iq = [], []
        seq_dirs = [d for d in Path(split_dir).iterdir() if d.is_dir()]
        for seq in natsorted(seq_dirs):
            for f in natsorted(Path(seq).iterdir()):
                if "envelope" in f.name:
                    env.append(f)
                elif "iq" in f.name:
                    iq.append(f)
        return env, iq

    # dataset-info interface shared by all datasets
    def get_channel_num(self) -> int:
        return 1

    def get_sample_num(self) -> int:
        return len(loadtxt(self.gt_iq[0]))

    def __len__(self) -> int:
        return len(self.gt_positions)

    def __getitem__(self, idx: int):
        envelope = loadtxt(self.samples_env[idx])
        iq = loadtxt(self.samples_iq[idx])
        iq_gt = loadtxt(self.gt_iq[idx])
        position = self.gt_positions[idx]
        label = self.labels[idx]

        # position [mm] -> round-trip ToF -> (upscaled) sample index
        toa = 2 * (position * 1e-3) / self.cfg["speed_of_sound"]
        gt_sample = toa * self.cfg["fhz_sample"] * self.rf_scale_factor

        iq = iq[:, 0] + 1j * iq[:, 1]
        iq_gt = iq_gt[:, 0] + 1j * iq_gt[:, 1]

        fc, fs = self.cfg["fhz_carrier"], self.cfg["fhz_sample"]
        rf = iq2rf_host(iq, fc, fs, self.rf_scale_factor)
        rf_gt = iq2rf_host(iq_gt, fc, fs, self.rf_scale_factor)
        envelope = upscale_1d(envelope, self.rf_scale_factor)

        if self.transforms is not None:
            with self._draw_lock:
                draw = self._draws[idx] = self._draws.get(idx, -1) + 1
            rng = np.random.default_rng((self._seed, idx, draw))
            # all three waveforms crop around the ORIGINAL GT index; only
            # rf's call updates gt_sample
            gt0 = gt_sample
            envelope, _ = self.transforms(envelope, gt0, rng=rng)
            rf, gt_sample = self.transforms(rf, gt0, rng=rng)
            rf_gt, _ = self.transforms(rf_gt, gt0, rng=rng)

        return (envelope.astype(np.float32), rf.astype(np.float32),
                rf_gt.astype(np.float32), np.float32(gt_sample),
                np.float32(position), label)
