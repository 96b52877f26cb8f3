"""Profiling (replaces ``stofnet_tpu/utils/profiling.py`` as far as the
driver goes): the parameter count, a window of driver steps traced by
``torch.profiler`` (``jax.profiler`` in the JAX package), and the
program's own spans.

The spans (no JAX counterpart) mark the serving call's parts and the
set-up's stages, so that a trace can say which part of the program the
host was in while the card worked or waited:

- :func:`span` marks a part of a call on the hot path. With no
  ``torch.profiler`` running in the thread it returns one shared no-op;
  with one running it opens a record function ``stofnet.<name>`` (so it
  appears in any trace the profiler writes, ``StepTraceProfiler``'s
  included) and keeps a :class:`Record` in a bounded buffer;
- :func:`once` marks a set-up stage that runs a few times a process (a
  kernel library's build and load, a pipeline's first call) and always
  keeps its record, with or without a profiler;
- :func:`recorded` returns the records kept, in memory only.

The record function is ``torch._C._profiler._RecordFunctionFast``, a
host event of the profiler's ``cpu_op`` kind, and not
``torch.profiler.record_function``: a user annotation also casts a
``gpu_user_annotation`` shadow on the card's timeline, which a reader of
a profiler that names no event kinds (torch 2.11 names none) cannot
tell from a kernel. It also costs a tenth as much.

A record's times are ``time.time_ns()``, the clock of the profiler's
events (its host events and the card's activity), taken just outside its
record function so that they bracket the event. Spans nest per thread:
a record names its parent, and the spans of one call (one root span and
what it holds) share the root's id.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from pathlib import Path
from typing import List, Mapping, NamedTuple, Optional

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


PREFIX = "stofnet."  # never ``bench.``: the benchmark's own spans
MAX_SPANS = 1 << 15  # spans kept: a 10-s traced slice holds under 10,000
MAX_ONCE = 1 << 10  # set-up stages kept
# whether a torch.profiler records this thread: the one check a span
# costs with none running
enabled = torch._C._autograd._profiler_enabled


class Record(NamedTuple):
    """A closed span: ``start`` and ``end`` in ``time.time_ns()``, its own
    ``id``, its ``parent``'s (None for a root) and its ``call``, the id of
    the root span it lies in (its own for a root)."""
    name: str
    start: int
    end: int
    id: int
    parent: Optional[int]
    call: int


_spans: deque = deque(maxlen=MAX_SPANS)
_once: deque = deque(maxlen=MAX_ONCE)
_ids = itertools.count(1)
_open = threading.local()  # .stack: the thread's open spans
_NOOP = contextlib.nullcontext()
_event = torch._C._profiler._RecordFunctionFast


class _Span:
    """An open span: on entry it takes its id and its parent from the
    thread's open spans, and opens its profiler event while a profiler
    runs; on exit it appends its :class:`Record` to ``buf``."""

    __slots__ = ("name", "buf", "id", "parent", "call", "start", "rf")

    def __init__(self, name: str, buf: deque):
        self.name, self.buf = name, buf

    def __enter__(self) -> "_Span":
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.id = next(_ids)
        top = stack[-1] if stack else None
        self.parent, self.call = ((top.id, top.call) if top is not None
                                  else (None, self.id))
        stack.append(self)
        self.rf = None
        self.start = time.time_ns()
        if enabled():
            self.rf = _event(PREFIX + self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self.rf is not None:
            self.rf.__exit__(*exc)
        end = time.time_ns()
        _open.stack.pop()
        self.buf.append(Record(self.name, self.start, end, self.id,
                               self.parent, self.call))


def span(name: str):
    """A part of a call, recorded while a profiler runs in this thread;
    the shared no-op otherwise."""
    if not enabled():
        return _NOOP
    return _Span(name, _spans)


def once(name: str) -> _Span:
    """A set-up stage: recorded always, and in a trace while a profiler
    runs."""
    return _Span(name, _once)


def recorded() -> List[Record]:
    """The records kept: the set-up stages (the last ``MAX_ONCE``), then
    the spans (the last ``MAX_SPANS``), each in the order they closed."""
    return [*_once, *_spans]
