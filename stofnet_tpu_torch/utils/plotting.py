"""Plotting (the port's own copy of ``stofnet_tpu/utils/plotting.py``):
per-channel waveform overviews and the model-comparison figure, the two
figures ``cli/main.py`` draws. matplotlib is imported inside each call;
where it is missing, ``cli/main.py`` draws nothing.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def plot_channel_overview(frame: np.ndarray, gt_samples: np.ndarray,
                          echoes: Optional[np.ndarray] = None,
                          envelope: Optional[np.ndarray] = None,
                          magnify_adjacent: bool = False, max_channels: int = 8):
    """Stacked per-channel waveforms with GT (dashed) and estimated (dotted)
    ToA markers. frame: (C, L) or (C, 1, L); gt/echoes: (C, K)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    frame = np.asarray(frame)
    if frame.ndim == 3:
        frame = frame[:, 0]
    c = min(frame.shape[0], max_channels)
    fig, axs = plt.subplots(c, 1, figsize=(12, 1.8 * c), squeeze=False,
                            sharex=True)
    for ci in range(c):
        ax = axs[ci, 0]
        wave = frame[ci]
        ax.plot(wave, lw=0.7, label="RF")
        if envelope is not None:
            ax.plot(np.abs(envelope[ci]), lw=0.7, label="envelope")
        lim = np.abs(wave).max() or 1.0
        for g in np.atleast_1d(np.asarray(gt_samples)[ci]).ravel():
            if g > 0 and np.isfinite(g):
                ax.axvline(g, color="g", ls="--", lw=1, alpha=0.8)
        if echoes is not None:
            for e in np.atleast_1d(np.asarray(echoes)[ci]).ravel():
                if e > 0 and np.isfinite(e):
                    ax.axvline(e, color="r", ls=":", lw=1, alpha=0.8)
        if magnify_adjacent:
            valid = [g for g in np.atleast_1d(np.asarray(gt_samples)[ci]).ravel()
                     if g > 0 and np.isfinite(g)]
            if valid:
                g0 = valid[0]
                ax.set_xlim(max(0, g0 - 200), min(len(wave), g0 + 200))
        ax.set_ylim(-1.05 * lim, 1.05 * lim)
        ax.set_ylabel(f"ch {ci}")
    axs[0, 0].legend(loc="upper right", fontsize=7)
    axs[-1, 0].set_xlabel("sample index")
    fig.tight_layout()
    return fig


def plot_comparison(channel_data: np.ndarray,
                    toa_list: Sequence[np.ndarray],
                    toa_labels: Sequence[str],
                    gt_samples: Optional[np.ndarray] = None,
                    zoom_halfwidth: int = 120,
                    save_path=None):
    """One waveform with per-model ToA markers + a zoom inset around the
    first GT echo (the reference's paper figure, plot_frame.py:9-97).

    ``save_path`` may be a single path or a sequence of paths; the format
    is inferred from each extension, so passing ``["fig.png", "fig.svg",
    "fig.eps"]`` reproduces the reference's vector exports
    (plot_frame.py:95-96 saves ``.svg`` + ``.eps``). usetex styling is
    deliberately not replicated (no TeX toolchain in the image)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    wave = np.asarray(channel_data).ravel()
    fig, ax = plt.subplots(figsize=(12, 4))
    ax.plot(wave, lw=0.8, color="k", alpha=0.7, label="RF frame")

    colors = plt.cm.tab10.colors
    centers = []
    for i, (toas, label) in enumerate(zip(toa_list, toa_labels)):
        for t in np.atleast_1d(np.asarray(toas)).ravel():
            if t > 0 and np.isfinite(t):
                ax.axvline(t, color=colors[i % 10], lw=1.2, alpha=0.9,
                           label=label)
                label = None  # only label the first marker
                centers.append(t)
    if gt_samples is not None:
        for g in np.atleast_1d(np.asarray(gt_samples)).ravel():
            if g > 0 and np.isfinite(g):
                ax.axvline(g, color="g", ls="--", lw=1.5, label="GT")
                centers.append(g)
                break

    if centers:
        c0 = centers[-1]
        lo, hi = int(max(0, c0 - zoom_halfwidth)), int(min(len(wave),
                                                           c0 + zoom_halfwidth))
        axins = ax.inset_axes([0.62, 0.55, 0.36, 0.4])
        axins.plot(np.arange(lo, hi), wave[lo:hi], lw=0.8, color="k")
        for i, toas in enumerate(toa_list):
            for t in np.atleast_1d(np.asarray(toas)).ravel():
                if lo < t < hi:
                    axins.axvline(t, color=colors[i % 10], lw=1.0)
        if gt_samples is not None:
            for g in np.atleast_1d(np.asarray(gt_samples)).ravel():
                if lo < g < hi:
                    axins.axvline(g, color="g", ls="--", lw=1.2)
        ax.indicate_inset_zoom(axins, edgecolor="gray")

    ax.set_xlabel("sample index")
    ax.set_ylabel("amplitude")
    ax.legend(loc="upper left", fontsize=8)
    fig.tight_layout()
    if save_path:
        paths = [save_path] if isinstance(save_path, (str, bytes)) or hasattr(
            save_path, "__fspath__") else list(save_path)
        for p in paths:
            fig.savefig(p, dpi=150)
    return fig


def fig_to_array(fig) -> np.ndarray:
    """Rasterize a figure to (H, W, 3) uint8 (the reference's wb_img_upload
    conversion, utils/plotting.py:7-13)."""
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())
    return buf[..., :3].copy()
