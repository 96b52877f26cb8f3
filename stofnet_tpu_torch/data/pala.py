"""PALA ultrasound-localization RF dataset (the port's own copy of
``stofnet_tpu/data/pala.py``; ``pala_config.yaml`` is read by the port's
flat-YAML reader, which takes the block lists ``yaml.safe_dump`` writes,
and written by its writer, not PyYAML).

The reference's ``datasets.pala_dataset`` submodule is absent upstream;
the JAX package reimplements its call-site contract, and this is that
contract:

  PalaDatasetRf(dataset_path, sequences, train, rescale_factor, ch_gap,
                angle_threshold, clutter_db, temporal_filter_opt,
                pow_law_opt, transforms)
  .get_key('angles_list' | 'fs' | 'c' | 'wavelength')
  .get_channel_num() / .get_sample_num()
  item -> 6-tuple with [0] frame (n_waves, C, L) and [2] gt_sample
          (n_waves, C, MAX_TARGETS); the driver selects wave index 1 and
          flattens channels into the batch.

On disk::

    dataset_path/
      pala_config.yaml   # fs, c, f0, t0, angles_list (rad), xe (element x [m])
      sequences/seq_XXX.npz
        rf:  (n_frames, n_angles, n_channels, n_samples) float32 RF
        pos: (n_frames, max_targets, 2) scatterer (x, z) [m], NaN-padded

Per-channel GT ToA follows plane-wave geometry: tau = (dtx + drx)/c with
dtx = z cos(theta) + x sin(theta) and drx = hypot(x - xe_k, z), in
(rescaled) sample indices; channels whose receive angle exceeds
``angle_threshold`` degrees get GT 0. ``clutter_db`` runs the SVD clutter
filter (``ops/svd_filter.svd_filter_db``, in torch on the host) over each
sequence's slow-time ensemble; ``temporal_filter_opt`` a 2-tap slow-time
high-pass that drops the first frame; ``pow_law_opt`` a sqrt depth gain.
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from stofnet_tpu_torch.utils.config import dump_flat_yaml, read_flat_yaml

MAX_TARGETS = 32


class PalaDatasetRf:
    def __init__(self, dataset_path, sequences: Sequence[int] = (0,),
                 train: bool = True, rescale_factor: int = 1,
                 ch_gap: int = 1, angle_threshold: float = 45.0,
                 clutter_db: Optional[float] = None,
                 temporal_filter_opt: bool = False, pow_law_opt: bool = False,
                 transforms=None, seed: int = 0):
        self.root = Path(dataset_path)
        self.rescale_factor = int(rescale_factor)
        self.ch_gap = max(int(ch_gap), 1)
        self.angle_threshold = float(angle_threshold)
        self.transforms = transforms
        self._seed = int(seed)
        # see chirp.py: thread-safe, order-independent per-item aug rng
        self._draw_lock = threading.Lock()
        self._draws: dict = {}

        path = self.root / "pala_config.yaml"
        self.cfg = read_flat_yaml(path.read_text(), str(path))
        self.cfg["wavelength"] = self.cfg["c"] / self.cfg["f0"]

        self.frames: List[np.ndarray] = []
        self.positions: List[np.ndarray] = []
        seq_dir = self.root / "sequences"
        for s in sequences:
            path = seq_dir / f"seq_{int(s):03d}.npz"
            if not path.exists():
                continue
            data = np.load(path)
            rf = np.asarray(data["rf"], np.float32)
            pos = np.asarray(data["pos"], np.float32)

            if temporal_filter_opt and rf.shape[0] > 1:
                # the slow-time high-pass drops the first frame: kept as
                # rf[0]-rf[0]=0 it would make NormalizeVol divide 0/0
                rf = np.diff(rf, axis=0)
                pos = pos[1:]
            if clutter_db is not None and rf.shape[0] > 2:
                rf = self._svd_clutter(rf, float(clutter_db))
            if pow_law_opt:
                gain = np.sqrt(np.linspace(1e-3, 1.0, rf.shape[-1]),
                               dtype=np.float32)
                rf = rf * gain

            for i in range(rf.shape[0]):
                self.frames.append(rf[i])
                self.positions.append(pos[i])

    @staticmethod
    def _svd_clutter(rf: np.ndarray, clutter_db: float) -> np.ndarray:
        """Slow-time SVD filter: drop the leading components stronger than
        ``clutter_db`` below the principal one (``svd_filter_db``)."""
        from stofnet_tpu_torch.ops.svd_filter import svd_filter_db

        # slow time (frames) is the trailing Casorati axis
        ens = torch.from_numpy(np.ascontiguousarray(np.moveaxis(rf, 0, -1)))
        out = svd_filter_db(ens, clutter_db).numpy()
        return np.moveaxis(out, -1, 0).astype(np.float32)

    def get_key(self, key: str):
        return self.cfg[key]

    def get_channel_num(self) -> int:
        n = len(np.asarray(self.cfg["xe"]))
        return len(range(0, n, self.ch_gap))

    def get_sample_num(self) -> int:
        return int(self.frames[0].shape[-1]) if self.frames else 0

    def __len__(self) -> int:
        return len(self.frames)

    def _gt_samples(self, pos: np.ndarray) -> np.ndarray:
        """(n_waves, C, MAX_TARGETS) GT sample indices; 0 = invalid."""
        xe = np.asarray(self.cfg["xe"], np.float64)[:: self.ch_gap]
        angles = np.asarray(self.cfg["angles_list"], np.float64)
        fs, c, t0 = self.cfg["fs"], self.cfg["c"], self.cfg.get("t0", 0.0)

        out = np.zeros((len(angles), len(xe), MAX_TARGETS), np.float32)
        valid = ~np.isnan(pos[:, 0])
        pts = pos[valid]
        for w, th in enumerate(angles):
            for t_i, (px, pz) in enumerate(pts[:MAX_TARGETS]):
                dtx = pz * np.cos(th) + px * np.sin(th)
                drx = np.hypot(px - xe, pz)
                tau = (dtx + drx) / c
                samples = (tau - t0) * fs * self.rescale_factor
                rx_angle = np.degrees(np.arctan2(np.abs(px - xe), pz))
                samples = np.where(rx_angle <= self.angle_threshold,
                                   samples, 0.0)
                out[w, :, t_i] = samples
        return out

    def __getitem__(self, idx: int):
        frame = self.frames[idx]  # (n_angles, C_full, L)
        frame = frame[:, :: self.ch_gap]
        if self.rescale_factor != 1:
            # raw index i maps exactly to upscaled index i*r, as
            # _gt_samples' samples*rescale_factor assumes (a linspace
            # endpoint grid would skew GT against the waveform)
            n = frame.shape[-1]
            x = np.arange(n, dtype=np.float64)
            t = np.arange(n * self.rescale_factor,
                          dtype=np.float64) / self.rescale_factor
            frame = np.stack([
                np.stack([np.interp(t, x, ch) for ch in wave])
                for wave in frame
            ]).astype(np.float32)

        gt = self._gt_samples(self.positions[idx])

        if self.transforms is not None:
            with self._draw_lock:
                draw = self._draws[idx] = self._draws.get(idx, -1) + 1
            rng = np.random.default_rng((self._seed, idx, draw))
            waves = []
            for w in range(frame.shape[0]):
                chans = []
                for c_ in range(frame.shape[1]):
                    wf, _ = self.transforms(frame[w, c_], None, rng=rng)
                    chans.append(wf)
                waves.append(np.stack(chans))
            frame = np.stack(waves).astype(np.float32)

        # 6-tuple: [0]=frame, [2]=gt_sample (the reference's contract)
        zeros = np.zeros(1, np.float32)
        return frame, zeros, gt, zeros, zeros, "pala"


def generate_pala_dataset(
    root: str | Path,
    n_sequences: int = 2,
    n_frames: int = 4,
    n_angles: int = 3,
    n_channels: int = 16,
    n_samples: int = 400,
    n_targets: int = 3,
    seed: int = 3008,
) -> Path:
    """Write a synthetic PALA-format dataset (microbubble point scatterers
    insonified by steered plane waves) for tests and demos."""
    root = Path(root)
    (root / "sequences").mkdir(parents=True, exist_ok=True)

    c, fs, f0 = 1540.0, 5e6, 5e6 / 4
    pitch = 3e-4
    xe = ((np.arange(n_channels) - (n_channels - 1) / 2) * pitch)
    angles = np.deg2rad(np.linspace(-5, 5, n_angles))
    cfg = {"fs": fs, "c": c, "f0": f0, "t0": 0.0,
           "angles_list": [float(a) for a in angles],
           "xe": [float(x) for x in xe]}
    (root / "pala_config.yaml").write_text(dump_flat_yaml(cfg))

    rng = np.random.default_rng(seed)
    t_axis = np.arange(n_samples)
    zmax = 0.8 * n_samples / fs * c  # one-way reachable depth
    for s in range(n_sequences):
        rf = np.zeros((n_frames, n_angles, n_channels, n_samples), np.float32)
        pos = np.full((n_frames, MAX_TARGETS, 2), np.nan, np.float32)
        for fidx in range(n_frames):
            px = rng.uniform(xe[0], xe[-1], n_targets)
            pz = rng.uniform(0.15 * zmax, 0.6 * zmax, n_targets)
            pos[fidx, :n_targets] = np.c_[px, pz]
            for w, th in enumerate(angles):
                for k in range(n_channels):
                    for x_, z_ in zip(px, pz):
                        tau = (z_ * np.cos(th) + x_ * np.sin(th)
                               + np.hypot(x_ - xe[k], z_)) / c
                        mu = tau * fs
                        pulse = (np.exp(-0.5 * ((t_axis - mu) / 3.0) ** 2)
                                 * np.cos(2 * np.pi * 0.25 * (t_axis - mu)))
                        rf[fidx, w, k] += pulse.astype(np.float32)
            rf[fidx] += 0.01 * rng.standard_normal(rf[fidx].shape)
        np.savez_compressed(root / "sequences" / f"seq_{s:03d}.npz",
                            rf=rf, pos=pos)
    return root
