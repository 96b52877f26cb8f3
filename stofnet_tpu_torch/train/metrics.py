"""Tolerance-matched ToA metrics (replaces
``stofnet_tpu/train/metrics.py:toa_rmse``).

GT and estimates are fixed-width tensors with 0/NaN/Inf marking invalid
slots, so the all-pairs match is one (B, G, E) broadcast on the device.
NaN semantics are the JAX function's: a row where either side has no valid
entry gives mes=tp=fp=fn=0 (so jaccard, precision and recall are
0/0 = NaN), and a valid row with no match within tolerance has mes = NaN
(the mean of an empty set).
"""

from __future__ import annotations

import torch


def _valid(x: torch.Tensor) -> torch.Tensor:
    return (x != 0) & torch.isfinite(x)


def toa_rmse(gt_samples: torch.Tensor, es_samples: torch.Tensor,
             tol: float = 1.0) -> torch.Tensor:
    """Match GT ToAs to their nearest estimates; returns (B, 7) float32 of
    [rmse, precision, recall, jaccard, tp, fp, fn] per row."""
    gt = torch.as_tensor(gt_samples).to(torch.float32)
    es = torch.as_tensor(es_samples).to(torch.float32)
    if gt.ndim == 1:
        gt = gt[:, None]
    if es.ndim == 1:
        es = es[:, None]

    gt_ok = _valid(gt)
    es_ok = _valid(es)
    row_ok = gt_ok.any(-1) & es_ok.any(-1)

    gtc = torch.where(gt_ok, gt, torch.zeros_like(gt))
    esc = torch.where(es_ok, es, torch.full_like(es, float("inf")))

    d = torch.square(gtc[:, :, None] - esc[:, None, :])  # (B, G, E)
    mins = d.amin(dim=-1)  # inf where no valid estimate

    matched = (mins <= tol) & gt_ok
    unmatched = (mins > tol) & gt_ok

    zero = torch.zeros_like(row_ok, dtype=torch.float32)
    tp = torch.where(row_ok, matched.sum(-1).to(torch.float32), zero)
    fn = torch.where(row_ok, unmatched.sum(-1).to(torch.float32), zero)
    fp = torch.where(row_ok, es_ok.sum(-1).to(torch.float32) - tp, zero)

    msum = torch.where(matched, mins, torch.zeros_like(mins)).sum(-1)
    mes = torch.sqrt(msum / tp)  # tp == 0 -> NaN
    mes = torch.where(row_ok, mes, zero)

    jaccard = tp / (fn + tp + fp) * 100.0
    precision = tp / (fp + tp) * 100.0
    recall = tp / (fn + tp) * 100.0
    return torch.stack([mes, precision, recall, jaccard, tp, fp, fn], dim=-1)
