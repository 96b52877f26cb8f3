"""Gradient-based echo detection, the classical GradPeak pipeline, as
static-shape tensor ops (replaces ``stofnet_tpu/ops/gradpeak.py``).

Hilbert envelope -> ``torch.gradient``-style differences -> Gaussian
smoothing -> hysteresis thresholds (auto threshold ``std**16 * 1.2e13`` in
f32, negative = -th/4) -> pairing of rising (+) and rising (-) edges under
interval and uniqueness constraints -> per echo (onset, peak, amplitude).

As in JAX, edge positions live in fixed (B, max_edges) int32 slots
(invalid = ``_BIG``), the pairing is an all-pairs masked argmin and the
uniqueness check an O(K^2) masked comparison; where a row keeps more pairs
than ``max_echoes`` slots, the strongest are kept. The tie rules are JAX's:
``lax.top_k`` and ``jnp.argsort`` put the lower index first, so every
ranking here is a stable sort (``torch.topk`` promises no order for ties)
and ``torch.argmin`` returns the first minimum, as ``jnp.argmin`` does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from stofnet_tpu_torch.ops.hilbert import hilbert_envelope

_BIG = 2 ** 30


def gradient1d(y: torch.Tensor, spacing: float = 1.0) -> torch.Tensor:
    """``torch.gradient`` semantics: central differences over 2*spacing
    inside, one-sided over spacing at the ends."""
    interior = (y[..., 2:] - y[..., :-2]) / (2.0 * spacing)
    left = (y[..., 1:2] - y[..., 0:1]) / spacing
    right = (y[..., -1:] - y[..., -2:-1]) / spacing
    return torch.cat([left, interior, right], dim=-1)


def gaussian_smooth(y: torch.Tensor, sigma: float,
                    num_sigmas: float = 3.0) -> torch.Tensor:
    """Gaussian filter of (B, L) rows with radius int(num_sigmas*sigma)+1
    (the reference's ceil convention), its taps built on the host in f64."""
    radius = int(num_sigmas * sigma) + 1
    support = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (support / sigma) ** 2)
    k = torch.from_numpy((k / k.sum()).astype(np.float32)).to(y.device)
    out = F.conv1d(y.reshape(y.shape[0], 1, -1), k.reshape(1, 1, -1),
                   padding=radius)
    return out.reshape(y.shape)


def _first_indices(mask: torch.Tensor, k: int) -> torch.Tensor:
    """The first k True positions of each row, ascending; invalid slots
    ``_BIG``."""
    n = mask.shape[-1]
    pos = torch.where(mask, torch.arange(n, dtype=torch.int32,
                                         device=mask.device), _BIG)
    return torch.topk(pos, k, dim=-1, largest=False, sorted=True).values


def _top(key: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest of each row, ties lower index first
    (``lax.top_k``)."""
    return torch.sort(key, dim=-1, descending=True, stable=True)[1][..., :k]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, j]]`` (a gather: ``take_along_dim`` broadcasts, and
    ``torch.export`` then pins a symbolic batch)."""
    return torch.gather(x, -1, idx.long())


def grad_peak_detect(data: torch.Tensor, grad_step: int = 2,
                     threshold: Optional[float] = None,
                     ival_smin: Optional[int] = None,
                     ival_smax: Optional[int] = None,
                     max_echoes: int = 64,
                     max_edges: int = 128) -> torch.Tensor:
    """Echoes of the envelopes ``data`` (B, L): (B, max_echoes, 3) of
    (onset, peak, amplitude), empty slots all zero."""
    grad = gradient1d(data, float(grad_step))
    grad = gaussian_smooth(grad, sigma=(grad_step * 2 - 1) / 6.0)

    if threshold is not None:
        thres_pos = torch.tensor(threshold, dtype=grad.dtype,
                                 device=grad.device)
    else:
        # the batch's unbiased std (torch.Tensor.std) to the 16th power by
        # squaring, as jnp's integer power
        c = grad - grad.mean()
        s = torch.sqrt((c * c).sum() / (grad.numel() - 1))
        for _ in range(4):
            s = s * s
        thres_pos = s * 1.2e13
    thres_neg = -thres_pos / 4.0

    # the reference's heuristic interval unless BOTH bounds are given
    if ival_smin is not None and ival_smax is not None:
        ival_lo, ival_hi = ival_smin, ival_smax
    else:
        ival_lo, ival_hi = grad_step // 2, grad_step * 3

    plus = grad > thres_pos
    minu = grad < thres_neg
    # rising edges: False -> True at diff index i
    rise_p = ~plus[..., :-1] & plus[..., 1:]
    rise_m = ~minu[..., :-1] & minu[..., 1:]

    ap = _first_indices(rise_p, max_edges)  # (B, K) ascending
    am = _first_indices(rise_m, max_edges)
    ap_ok = ap < _BIG
    am_ok = am < _BIG

    # for each negative edge, the nearest preceding positive edge
    dmat = am[:, None, :] - ap[:, :, None]  # (B, Kap, Kam)
    dmat = torch.where(dmat < 0, _BIG, dmat)
    dmat = torch.where(ap_ok[:, :, None], dmat, _BIG)
    sel = torch.argmin(dmat.abs(), dim=1)  # (B, Kam)
    ap_sel = _take(ap, sel)

    gaps = am - ap_sel
    valid = am_ok & (gaps > ival_lo) & (gaps < ival_hi)

    # uniqueness: the first (earliest am) pair of each distinct onset
    eq = ap_sel[:, :, None] == ap_sel[:, None, :]  # (B, Kam, Kam)
    k = ap_sel.shape[-1]
    earlier = torch.tril(torch.ones(k, k, dtype=torch.bool,
                                    device=data.device), diagonal=-1)
    dup = (eq & earlier[None] & valid[:, None, :]).any(-1)
    keep = valid & ~dup

    # the strongest kept pairs into max_echoes slots, then by ascending
    # peak time with empty slots last
    amp_all = _take(data, am.clamp(0, data.shape[-1] - 1))
    strength = torch.where(keep, amp_all, float("-inf"))
    top = _top(strength, max_echoes)
    kept_t = _take(keep, top)
    tkey = torch.where(kept_t, _take(am, top), _BIG)
    order = _take(top, torch.argsort(tkey, dim=-1, stable=True))

    onset = _take(ap_sel, order)
    peak = _take(am, order)
    kept = _take(keep, order)
    amp = _take(data, peak.clamp(0, data.shape[-1] - 1))

    onset = torch.where(kept, onset, 0).to(torch.float32)
    peak = torch.where(kept, peak, 0).to(torch.float32)
    amp = torch.where(kept, amp, 0.0)
    return torch.stack([onset, peak, amp], dim=-1)


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, j], :]`` of (B, M, C) echoes, a gather as :func:`_take`."""
    return torch.gather(x, 1, idx.long()[..., None].expand(
        -1, -1, x.shape[-1]))


def reduce_echoes(echoes: torch.Tensor, echo_max: int, time_col: int = 1,
                  amp_col: int = -1) -> torch.Tensor:
    """The echo_max strongest echoes, re-sorted by arrival time (reference
    gradpeak.py:107-114); invalid slots sort first and come out zero."""
    if echo_max >= echoes.shape[1]:
        return echoes
    valid = echoes[..., time_col] > 0
    amp_key = torch.where(valid, echoes[..., amp_col], float("-inf"))
    top = _top(amp_key, echo_max)
    picked = _take_rows(echoes, top)
    pvalid = _take(valid, top)
    tkey = torch.where(pvalid, picked[..., time_col], 0.0)
    order = torch.argsort(tkey, dim=-1, stable=True)
    out = _take_rows(picked, order)
    ovalid = _take(pvalid, order)
    return torch.where(ovalid[..., None], out, 0.0)


def toa_detect(frame: torch.Tensor, threshold: Optional[float] = None,
               rescale_factor: int = 1, echo_max: Optional[int] = None,
               max_echoes: int = 64,
               max_edges: Optional[int] = None) -> torch.Tensor:
    """The classical pipeline on raw RF rows (B, L): envelope ->
    :func:`grad_peak_detect` -> optional strongest-echo pruning.

    The reference's grad step ``rescale_factor // 6 * 5`` is 0 below 6,
    where ``torch.gradient`` fails; JAX substitutes the detector's default
    step 2 there, and so does this copy. ``max_edges`` defaults to
    min(2048, max(128, ceil(L / 8)))."""
    env = hilbert_envelope(frame)
    if max_edges is None:
        max_edges = int(min(2048, max(128, -(-frame.shape[-1] // 8))))
    step = rescale_factor // 6 * 5
    echoes = grad_peak_detect(
        env, grad_step=step if step > 0 else 2, ival_smin=rescale_factor,
        ival_smax=50 * rescale_factor, threshold=threshold,
        max_echoes=max_echoes, max_edges=max_edges)
    if echo_max is not None and echo_max < max_echoes:
        echoes = reduce_echoes(echoes, echo_max)
    return echoes
