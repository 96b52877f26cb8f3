"""Profiling (replaces ``stofnet_tpu/utils/profiling.py`` as far as the
driver goes): the parameter count, and a window of driver steps traced by
``torch.profiler`` (``jax.profiler`` in the JAX package).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Mapping, Optional

import torch


def count_params(state: Mapping[str, torch.Tensor]) -> int:
    """Elements of every tensor of a state dict (or of named parameters)."""
    return sum(int(t.numel()) for t in state.values())


class StepTraceProfiler:
    """Trace a window of driver steps into a Chrome trace (Perfetto,
    ``chrome://tracing``).

    ``profile_dir=DIR`` enables it and ``profile_steps=N`` (default 5)
    sizes the window. The window starts after the first step, so the
    first step's one-time work (cuDNN's algorithm search, the allocator's
    first blocks) stays out of it, covers steps 2..N+1, and closes after
    them: one window a run, written to ``DIR/trace_<ns>.json``. The
    profiler records the CPU, and the card where the run is on one.
    ``close()`` writes a window the loop ended inside. ``path`` names the
    trace once written.
    """

    def __init__(self, profile_dir: Optional[str], steps: int = 5):
        self.dir = Path(profile_dir) if profile_dir else None
        self.n = max(1, int(steps))
        self._seen = 0
        self._prof = None
        self.path: Optional[Path] = None

    def step(self) -> None:
        """Call once per driver step, after the step's device work."""
        if self.dir is None:
            return
        self._seen += 1
        if self._prof is None and self._seen == 1:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
        elif self._prof is not None and self._seen >= 1 + self.n:
            self._stop()

    def close(self) -> None:
        if self._prof is not None:
            self._stop()

    def _stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.path = self.dir / f"trace_{time.time_ns()}.json"
        self._prof.export_chrome_trace(str(self.path))
        self._prof = None
        self.dir = None  # one window per run
