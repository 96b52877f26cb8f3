"""Ideal-threshold search via ROC g-mean (the port's own copy of
``stofnet_tpu/train/threshold.py``).

The reference runs sklearn's ``roc_curve`` on the first batch element
(positive label = the GLOBAL ``masks_true.max()``) and maximizes
sqrt(tpr * (1-fpr)). This is a logging-only diagnostic, so it runs on the
host in numpy (no sklearn): thresholds walk the descending unique scores,
with the conventional leading (fpr=0, tpr=0) point at threshold ``inf``
(sklearn >= 1.3). Degenerate label vectors (no positives / no negatives)
give NaN rates as in sklearn, so ``argmax`` lands on index 0 and the
returned threshold is ``inf``.
"""

from __future__ import annotations

import numpy as np


def roc_curve(y_true: np.ndarray, y_score: np.ndarray):
    """Minimal ROC matching sklearn's defaults: distinct score cuts with
    collinear intermediate points dropped (drop_intermediate=True), plus the
    conventional leading (0, 0) point at threshold inf."""
    order = np.argsort(-y_score, kind="stable")
    y = y_true[order].astype(np.float64)
    s = y_score[order].astype(np.float64)

    tps = np.cumsum(y)
    fps = np.cumsum(1.0 - y)
    # keep the last index of each distinct score (threshold boundary)
    distinct = np.r_[np.nonzero(np.diff(s))[0], s.size - 1]
    tps, fps, thr = tps[distinct], fps[distinct], s[distinct]

    if tps.size > 2:  # drop points collinear in the (fps, tps) staircase
        keep = np.r_[True,
                     np.logical_or(np.diff(fps, 2), np.diff(tps, 2)) != 0,
                     True]
        tps, fps, thr = tps[keep], fps[keep], thr[keep]

    # prepend the conventional (0, 0) point BEFORE normalizing: sklearn
    # divides the whole array, so degenerate labels (no positives or no
    # negatives) make every rate NaN including the leading point
    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    thresholds = np.r_[np.inf, thr]
    with np.errstate(invalid="ignore", divide="ignore"):
        tpr = tps / tps[-1]
        fpr = fps / fps[-1]
    return fpr, tpr, thresholds


def find_threshold(masks_pred, masks_true, window_size: int = 0,
                   norm_opt: bool = False) -> float:
    """G-mean-optimal threshold on the first batch element.

    NB (reference semantics): with norm_opt the WHOLE batch tensor is
    min/max-normalized before element 0 is evaluated (threshold.py:11-13),
    and the positive-label value is the GLOBAL ``masks_true.max()``
    (threshold.py:17), not element 0's max.
    """
    full = np.asarray(masks_pred, dtype=np.float64)
    scores = full[0].ravel().copy()
    if norm_opt:
        mn = full.min()
        rng = full.max() - mn
        scores -= mn
        if rng != 0:
            scores /= rng
    else:
        scores[scores < 0] = 0.0

    global_max = float(np.asarray(masks_true, dtype=np.float64).max())
    max_val = global_max if global_max != 0 else 1.0
    truth = np.asarray(masks_true[0], dtype=np.float64).ravel()
    labels = (truth == max_val).astype(np.float64)

    fpr, tpr, thresholds = roc_curve(labels, scores)
    with np.errstate(invalid="ignore"):
        gmeans = np.sqrt(tpr * (1.0 - fpr))
    # np.argmax over NaNs returns the first NaN index -> threshold inf for
    # degenerate labels, matching the sklearn + numpy reference behavior
    return float(thresholds[int(np.argmax(gmeans))])
