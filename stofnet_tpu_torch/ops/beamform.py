"""Delay-and-sum (DAS) beamforming of plane/diverging-wave ultrasound
(replaces ``stofnet_tpu/ops/beamform.py``).

Per TX angle a virtual source models the emission; per RX channel the
travel times map to fractional sample indices, which are linearly
resampled, phase-rotated back to RF (IQ inputs), masked by an F-number
aperture and summed over channels. Angles are compounded and
log-compressed to a normalized B-mode.

The delays are geometry: :func:`make_delay_table` computes them on the
host in float64 (its own copy of JAX's; the virtual source subtracts two
distances of about 1e5 m, which cancel catastrophically in f32).

:func:`das_rx_batch` is the same function as JAX's, computed in another
form. JAX's is TPU-specific: per channel a (P, N) band matrix (1 - frac at
idxf, frac at idxf + 1, masked) fed to the MXU, scanned over the K
channels. Here it is the gather form the band matrix encodes: for every
(pixel, channel) the floor and ceiling samples are gathered from the
frames, lerped, masked, phase-rotated and summed over channels, which
moves the (F, P, K) gathers instead of K band matrices of P x N (at the
B-mode figure's geometry 3.6 GB of complex64 gathers against 38.7 GB of
bands written a batch). JAX
has no Pallas kernel here, and this is plain PyTorch on the CPU and the
card alike. Real RF through an ``iq=True`` table stays real (the
``has_phase`` guard).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch


class BeamformParams(NamedTuple):
    """Acquisition geometry (the reference's ``param`` object)."""

    xe: np.ndarray  # (K,) element x-positions [m]
    c: float  # speed of sound [m/s]
    fs: float  # sample rate [Hz]
    t0: float  # acquisition start time [s]
    f0: float  # demodulation frequency [Hz] (0 for RF input)
    angles_list: Sequence[float]  # TX steering angles [rad]


class DelayTable(NamedTuple):
    """Host-computed per-(pixel, channel) resampling constants."""

    idxf: np.ndarray  # (P, K) int32 floor sample index
    frac: np.ndarray  # (P, K) f32 fractional part
    invalid: np.ndarray  # (P, K) bool out-of-range mask
    phase: Optional[np.ndarray]  # (P, K) complex64 IQ->RF rotation
    aperture: np.ndarray  # (P, K) bool F-number mask


def make_delay_table(params: BeamformParams, theta: float, x: np.ndarray,
                     z: np.ndarray, n_samples: int, fnumber: float = 1.9,
                     iq: bool = True) -> DelayTable:
    """Delays in f64 for one TX angle over flattened pixels x/z."""
    xe = np.asarray(params.xe, np.float64)
    x = np.asarray(x, np.float64)
    z = np.asarray(z, np.float64)

    # virtual source behind the array (non-planar wave assumption)
    beta = 1e-8
    width = xe[-1] - xe[0]
    vs_x = -width * np.cos(theta) * np.sin(theta) / beta
    vs_z = -width * np.cos(theta) ** 2 / beta

    dtx = np.hypot(x - vs_x, z - vs_z) - np.hypot(
        (abs(vs_x) - width / 2) * (abs(vs_x) > width / 2), vs_z
    )  # (P,)
    drx = np.hypot(x[:, None] - xe[None, :], z[:, None])  # (P, K)
    tau = (dtx[:, None] + drx) / params.c

    idxt = (tau - params.t0) * params.fs
    invalid = (idxt < 1) | (idxt > n_samples - 1)
    idx = np.where(invalid, 1.0, idxt)
    idxf = np.floor(idx).astype(np.int32)
    frac = (idx - idxf).astype(np.float32)

    phase = (np.exp(2j * np.pi * params.f0 * tau).astype(np.complex64)
             if iq else None)
    aperture = np.abs(x[:, None] - xe[None, :]) < (z[:, None] / fnumber / 2)
    return DelayTable(idxf, frac, invalid, phase, aperture)


def das_rx_batch(sigs: torch.Tensor, table: DelayTable) -> torch.Tensor:
    """Beamform a batch of frames for one TX event: (F, N, K) -> (F, P),
    complex where the input is complex and the table has a phase.

    At ``idxf = N - 1`` (then ``frac`` is 0) the ceiling sample is read at
    N - 1 with weight 0, as the band matrix has no column N."""
    f_frames, n, k = sigs.shape
    dev = sigs.device
    if not sigs.is_complex():
        sigs = sigs.to(torch.float32)
    # the flat indices (sample * K + channel) are built where the frames
    # are, from the table's int32 floor index
    chan = torch.arange(k, device=dev)
    idxf = torch.from_numpy(table.idxf).to(dev).long()
    lo_at = (idxf * k + chan).reshape(-1)
    hi_at = (torch.clamp(idxf + 1, max=n - 1) * k + chan).reshape(-1)
    mask = (torch.from_numpy(~table.invalid).to(dev)
            & torch.from_numpy(table.aperture).to(dev))
    frac = torch.from_numpy(table.frac).to(dev)
    w_hi = torch.where(mask, frac, 0.0)
    w_lo = torch.where(mask, 1.0 - frac, 0.0)
    flat = sigs.reshape(f_frames, n * k)
    shape = (f_frames,) + table.idxf.shape
    temp = (flat[:, lo_at].reshape(shape) * w_lo
            + flat[:, hi_at].reshape(shape) * w_hi)
    if sigs.is_complex() and table.phase is not None:
        temp = temp * torch.from_numpy(table.phase).to(dev)
    return temp.sum(-1)


def das_rx_apply(sig: torch.Tensor, table: DelayTable) -> torch.Tensor:
    """Beamform one TX event with precomputed delays: (N, K) -> (P,)."""
    return das_rx_batch(sig[None], table)[0]


def das_rx(sig: torch.Tensor, params: BeamformParams, theta: float,
           x: np.ndarray, z: np.ndarray,
           fnumber: float = 1.9) -> torch.Tensor:
    """Delay table and apply for one TX angle (the reference's
    ``bf_das_rx``, flattened pixels)."""
    table = make_delay_table(params, theta, np.asarray(x), np.asarray(z),
                             sig.shape[0], fnumber, iq=sig.is_complex())
    return das_rx_apply(sig, table)


def _bmode(iq: torch.Tensor) -> torch.Tensor:
    """Log-compressed magnitude of (..., P) pixels, each row's -inf (zero
    magnitude) raised to its finite minimum, its maximum at 0 dB."""
    mag = torch.abs(iq)
    bmode = 20.0 * torch.log10(torch.where(mag > 0, mag, 1.0))
    bmode = torch.where(mag > 0, bmode, float("-inf"))
    finite = torch.isfinite(bmode)
    finite_min = torch.where(finite, bmode, float("inf")).amin(
        -1, keepdim=True)
    bmode = torch.where(finite, bmode, finite_min)
    return bmode - bmode.amax(-1, keepdim=True)


def bf_das_batch(rf_iq: torch.Tensor, params: BeamformParams,
                 grid_x: np.ndarray, grid_z: np.ndarray,
                 fnumber: float = 1.9) -> torch.Tensor:
    """Batched B-mode beamforming: (F, n_angles, N, K) -> (F, Z, X) dB,
    angles compounded through :func:`das_rx_batch`, each frame normalized
    as :func:`bf_das` normalizes its image."""
    xg, zg = np.meshgrid(np.asarray(grid_x), np.asarray(grid_z))
    xf, zf = xg.ravel(), zg.ravel()
    n = rf_iq.shape[2]
    acc = 0
    for a in range(rf_iq.shape[1]):
        table = make_delay_table(params, float(params.angles_list[a]),
                                 xf, zf, n, fnumber, iq=rf_iq.is_complex())
        acc = acc + das_rx_batch(rf_iq[:, a], table)  # (F, P)
    return _bmode(acc).reshape((rf_iq.shape[0],) + xg.shape)


def bf_das(rf_iq: torch.Tensor, params: BeamformParams, grid_x: np.ndarray,
           grid_z: np.ndarray, compound: bool = True,
           fnumber: float = 1.9) -> torch.Tensor:
    """Beamform a multi-angle acquisition (n_angles, N, K) to a normalized
    B-mode image: (Z, X) dB, or (n_angles, Z, X) when not compounding (one
    normalization over all of it, as the reference's)."""
    xg, zg = np.meshgrid(np.asarray(grid_x), np.asarray(grid_z))
    xf, zf = xg.ravel(), zg.ravel()
    frames = torch.stack([
        das_rx(rf_iq[a], params, float(params.angles_list[a]), xf, zf,
               fnumber=fnumber)
        for a in range(len(params.angles_list))])  # (n_angles, P)
    iq = frames.sum(0) if compound else frames
    bmode = _bmode(iq.reshape(-1)).reshape(iq.shape)
    return bmode.reshape(xg.shape if compound
                         else (len(params.angles_list),) + xg.shape)
