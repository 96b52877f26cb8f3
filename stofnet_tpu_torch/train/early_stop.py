"""Early stopping on non-improving validation loss (the port's own copy of
``stofnet_tpu/train/early_stop.py``): the counter increments whenever
-val_loss fails to beat best+delta, and stops at ``patience``.
"""

from __future__ import annotations

from typing import Optional


class EarlyStopping:
    def __init__(self, patience: int = 5, delta: float = 0.0, verbose=print):
        self.patience = patience
        self.delta = delta
        self.counter = 0
        self.best_score: Optional[float] = None
        self.early_stop = False
        self.verbose = verbose

    def __call__(self, val_loss: float) -> bool:
        score = -val_loss
        if self.best_score is None:
            self.best_score = score
        elif score < self.best_score + self.delta:
            self.counter += 1
            if self.verbose:
                self.verbose(
                    f"EarlyStopping counter: {self.counter} / {self.patience}")
            if self.counter >= self.patience:
                self.early_stop = True
        else:
            self.best_score = score
            self.counter = 0
        return self.early_stop
