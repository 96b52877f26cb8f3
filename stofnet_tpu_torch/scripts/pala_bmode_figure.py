"""PALA imaging end to end (replaces ``scripts/pala_bmode_figure.py``):
a synthetic RF ensemble -> SVD clutter filter -> analytic signal -> DAS
beamforming -> a B-mode figure with the ground-truth scatterers::

    python -m stofnet_tpu_torch.scripts.pala_bmode_figure [out.png] \\
        [--device cpu]

The stages: ``data/pala.generate_pala_dataset`` (one sequence of 24
frames, 3 angles, 128 channels, 1024 samples, 3 targets), ``svd_filter``
with ``lo_cut=2`` over each (angle, channel) slow-time ensemble,
``ops/hilbert.analytic_signal`` along the samples and
``ops/beamform.bf_das_batch`` on a 128 x 192 pixel grid (the aperture
across; 0.10-0.65 of the generator's reachable depth down), on the card
unless ``--device cpu``. It prints the beamforming's time per frame, read
with CUDA events on the card (the host clock on the CPU), and saves
``build/PALA_bmode.png`` unless another path is given. matplotlib is
imported inside :func:`draw` only: the compute stages need none.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from stofnet_tpu_torch import resolve_device
from stofnet_tpu_torch.data.pala import PalaDatasetRf, generate_pala_dataset
from stofnet_tpu_torch.ops.beamform import BeamformParams, bf_das_batch
from stofnet_tpu_torch.ops.hilbert import analytic_signal
from stofnet_tpu_torch.ops.kernels._timing import time_once
from stofnet_tpu_torch.ops.svd_filter import svd_filter

GEOMETRY = dict(n_sequences=1, n_frames=24, n_targets=3, n_channels=128,
                n_samples=1024)
GRID = (128, 192)  # pixels across, down


def geometry(ds: PalaDatasetRf, n_samples: int, nx: int = GRID[0],
             nz: int = GRID[1]) -> Tuple[BeamformParams, np.ndarray,
                                         np.ndarray]:
    """The acquisition's ``BeamformParams`` and the image grid: the
    aperture across, 0.10-0.65 of the generator's one-way reachable depth
    (its targets lie in 0.15-0.6) down."""
    xe = np.asarray(ds.get_key("xe"))
    params = BeamformParams(
        xe=xe, c=float(ds.get_key("c")), fs=float(ds.get_key("fs")),
        t0=float(ds.get_key("t0")), f0=float(ds.get_key("f0")),
        angles_list=np.asarray(ds.get_key("angles_list")))
    zmax = 0.8 * n_samples / params.fs * params.c
    return (params, np.linspace(xe[0], xe[-1], nx),
            np.linspace(0.10 * zmax, 0.65 * zmax, nz))


def load_frames(ds: PalaDatasetRf) -> np.ndarray:
    """Every frame of the dataset: (F, angles, C, L) f32."""
    return np.stack([np.asarray(ds[i][0]) for i in range(len(ds))])


def clutter_filter(frames: torch.Tensor, lo_cut: int = 2) -> torch.Tensor:
    """``svd_filter(lo_cut)`` of each (angle, channel) slow-time ensemble
    of (F, angles, C, L) frames; returns (F, angles, L, C)."""
    f, a, c, n = frames.shape
    ens = frames.permute(1, 2, 3, 0).reshape(a * c, n, f)
    filt = svd_filter(ens, lo_cut=lo_cut)
    return filt.reshape(a, c, n, f).permute(3, 0, 2, 1)


def image(frames: torch.Tensor, params: BeamformParams, gx: np.ndarray,
          gz: np.ndarray) -> torch.Tensor:
    """The envelope B-mode of (F, angles, L, C) RF frames: their analytic
    signal, beamformed as IQ: (F, Z, X) dB."""
    return bf_das_batch(analytic_signal(frames, axis=2), params, gx, gz)


def draw(bmode: np.ndarray, pos: np.ndarray, gx: np.ndarray, gz: np.ndarray,
         out: Path) -> None:
    """The B-mode in grayscale dB (-40..0) with the scatterers as open
    circles, saved to ``out``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(5.2, 6.0))
    im = ax.imshow(bmode, cmap="gray", vmin=-40, vmax=0, aspect="auto",
                   extent=[gx[0] * 1e3, gx[-1] * 1e3,
                           gz[-1] * 1e3, gz[0] * 1e3])
    ax.scatter(pos[:, 0] * 1e3, pos[:, 1] * 1e3, s=90, marker="o",
               facecolors="none", edgecolors="#e4683a", linewidths=1.8,
               label="GT scatterers")
    ax.set_xlabel("lateral [mm]")
    ax.set_ylabel("depth [mm]")
    ax.set_title("PALA pipeline: SVD clutter filter → DAS beamform")
    ax.legend(loc="lower right", framealpha=0.85)
    fig.colorbar(im, ax=ax, label="B-mode [dB]", shrink=0.8)
    fig.tight_layout()
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out, dpi=130)
    plt.close(fig)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out", nargs="?", default="build/PALA_bmode.png")
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    with tempfile.TemporaryDirectory() as td:
        root = generate_pala_dataset(Path(td) / "pala_synth", **GEOMETRY)
        ds = PalaDatasetRf(root, sequences=[0], rescale_factor=1, ch_gap=1)
        params, gx, gz = geometry(ds, GEOMETRY["n_samples"])
        frames = torch.from_numpy(load_frames(ds)).to(dev)
        filt, svd_ms = time_once(clutter_filter, frames, device=dev)
        image(filt, params, gx, gz)  # cuFFT's plans, the first launches
        bmodes, bf_ms = time_once(image, filt, params, gx, gz, device=dev)
        pos = ds.positions[0]
        pos = pos[~np.isnan(pos[:, 0])]
    f, a, c, _ = frames.shape
    print(f"clutter filter {svd_ms:.2f} ms; beamformed {f} frames ({a} "
          f"angles, {c} ch, {len(gx)}x{len(gz)} px) in {bf_ms:.2f} ms, "
          f"{bf_ms / f:.3f} ms a frame on {dev}", file=sys.stderr)
    out = Path(args.out)
    draw(bmodes[0].cpu().numpy(), pos, gx, gz, out)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
