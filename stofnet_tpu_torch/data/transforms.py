"""Host-side data augmentation (the port's own copy of
``stofnet_tpu/data/transforms.py``): NormalizeVol, AddNoise (SNR-scaled
uniform noise), CropChannelData (random crop window around the GT ToA with
shift, zero-pad or resize) and Compose, in numpy.

Every transform is ``(waveform, gt, rng=None) -> (waveform, gt)``; gt may
be None. Randomized transforms draw from the per-call ``rng`` when given
(datasets pass a generator derived from (seed, item index, draw), which
makes augmentation thread-safe under the thread-pool loader and
independent of loading order), else from their constructor-time generator.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class NormalizeVol:
    """Scale to unit peak amplitude."""

    def __call__(self, waveform: np.ndarray, gt=None, rng=None):
        return waveform / np.abs(waveform).max(), gt


class AddNoise:
    """Add uniform noise at the given SNR [dB]; zero-mean for bipolar
    signals, positive-mean for envelopes. The SNR normalizer sums over the
    whole waveform (the true SNR)."""

    def __init__(self, snr: float = 40, rng: Optional[np.random.Generator] = None):
        self.snr = snr
        self.rng = rng or np.random.default_rng()

    def __call__(self, waveform: np.ndarray, gt=None, rng=None):
        rng = rng or self.rng
        mean, spread = (0.5, 2.0) if (waveform < 0).any() else (0.0, 1.0)
        noise = spread * (rng.random(waveform.shape) - mean)
        scale = (10 ** (-self.snr / 10)
                 * (np.sum(waveform ** 2) / np.sum(noise ** 2))) ** 0.5
        return waveform + noise * scale, gt


class CropChannelData:
    """Randomly crop a ``ratio`` window around the GT ToA (shifted within
    bounds), then zero-pad (or resize) back to the original length; the GT
    sample index shifts accordingly."""

    def __init__(self, ratio: Optional[float] = None, resize: bool = False,
                 rng: Optional[np.random.Generator] = None):
        self.resize = resize
        self.rng = rng or np.random.default_rng()
        # with ratio=None the first draw sticks: every item crops with the
        # same width. Drawn here, not at the first call, so the run-wide
        # width depends on the construction rng alone and not on which
        # loader thread's item gets there first.
        self.ratio = float(self.rng.random()) if ratio is None else ratio

    def __call__(self, waveform: np.ndarray, gt: float, rng=None):
        if gt is None:  # no ToA to anchor the crop on
            return waveform, gt
        rng = rng or self.rng
        ratio = self.ratio
        if not (0 < ratio < 1):
            return waveform, gt

        size = waveform.shape[0]
        width = int(round(size * ratio))
        ref = int(round(float(gt)))

        start = max(0, ref - width // 2)
        end = min(ref + width // 2, size)
        if end == size:
            start = end - width
        if start == 0:
            end = width

        # random shift keeping the window around the reference index
        max_dist = min(ref - start, end - ref)
        lo = -min(start, max_dist // 2)
        hi = min(size - end, max_dist // 2)
        shift = int(rng.integers(lo, hi)) if hi > lo else lo
        start += shift
        end += shift

        cropped = waveform[start:end]
        gt = gt - start

        if self.resize:
            factor = size / cropped.shape[0]
            x = np.linspace(0, cropped.shape[0], cropped.shape[0])
            t = np.linspace(0, cropped.shape[0], size)
            cropped = np.interp(t, x, cropped)
            gt = gt * factor
        else:
            cropped = np.pad(cropped, (0, size - cropped.shape[0]))
        return cropped, gt


class Compose:
    """Apply transforms in order, threading (waveform, gt[, rng])."""

    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, waveform, gt=None, rng=None):
        for t in self.transforms:
            waveform, gt = t(waveform, gt, rng=rng)
        return waveform, gt
