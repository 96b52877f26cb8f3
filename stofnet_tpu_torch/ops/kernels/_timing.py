"""CUDA-event timing of a call on the card (no JAX counterpart), the one
yardstick of ``chip_smoke.py`` and ``scripts/dma_probe.py``."""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch


def time_ms(fn: Callable, args_list: Sequence[tuple], iters: int = 20
            ) -> float:
    """Median CUDA-event time in ms of ``fn(*args)`` over ``iters`` calls
    after two warm-up calls, cycling through ``args_list`` so each call
    reads another input than the one before (with inputs larger than the
    50 MB L2 cache, none reads the previous call's data from it)."""
    for args in args_list[:2]:  # warm-up
        fn(*args)
    torch.cuda.synchronize()
    events = []
    for i in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args_list[i % len(args_list)])
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))
