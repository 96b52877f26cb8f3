"""The traced window: ``torch.profiler`` around the measured window, the
benchmark's own spans, and what the per-layer readers read from them.

A span is a ``record_function`` named ``bench.<name>`` that the drivers
open around their calls into each layer; ``bench.window`` spans the
traced slice of the measured window (:class:`Tracer`). Outside the slice,
and with tracing off, a span is a no-op.

From the profiler's events (``kineto_results.events()``, one pass):

- device activity: kernels, copies and fills on the card, each with the
  host time of the runtime call that launched it (by correlation id);
- spans: the benchmark's spans, by name (a driver's spans follow each
  other without nesting);
- ``busy_s``: the union of device activity inside the window; the idle
  gaps between, each named by the innermost span the host was in at the
  gap's middle.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch

PREFIX = "bench."
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 96  # kernel names are long templates: keep their heads
TRACED_S = 10.0  # seconds of a traced run's window that the profiler sees


class Op(NamedTuple):
    name: str
    kind: str  # one of DEVICE_KINDS
    start: float  # seconds, the profiler's clock
    end: float
    launched: Optional[float]  # host time of the launching call


class Span(NamedTuple):
    name: str  # without the prefix
    start: float
    end: float


def _ns(event, what: str) -> int:
    """``start`` or ``duration`` of an event in ns (older profilers give
    microseconds only)."""
    ns = getattr(event, f"{what}_ns", None)
    return ns() if ns is not None else int(getattr(event, f"{what}_us")()
                                            * 1000)


def _kind(event) -> str:
    """One of DEVICE_KINDS, ``runtime`` (a CUDA runtime or driver call),
    ``span`` (a benchmark span on the host) or ``other``. Where the
    profiler names no activity type, by the device and the name."""
    name = event.name()
    kind = getattr(event, "activity_type", None)
    if kind is not None:
        kind = str(kind())
        if kind in DEVICE_KINDS:
            return kind
        if kind in ("cuda_runtime", "cuda_driver"):
            return "runtime"
        return "span" if (kind == "user_annotation"
                          and name.startswith(PREFIX)) else "other"
    if event.device_type() == torch.autograd.DeviceType.CUDA:
        if name.startswith(PREFIX):
            return "other"  # the span's shadow on the device's timeline
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if name.startswith(PREFIX):
        return "span"
    return "runtime" if name.startswith("cu") else "other"


class Trace:
    """The traced window's records."""

    def __init__(self, ops: List[Op], spans: List[Span]):
        self.ops = ops
        self.spans = spans
        win = [s for s in spans if s.name == "window"]
        if not win:
            raise RuntimeError("the trace holds no bench.window span")
        self.start, self.end = win[0].start, win[0].end
        self.window_s = self.end - self.start
        inner = sorted((s for s in spans if s.name != "window"),
                       key=lambda s: s.start)
        self._inner = inner
        self._starts = [s.start for s in inner]
        self._busy = self._union()

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        events = prof.profiler.kineto_results.events()
        launch: Dict[int, float] = {}
        device, spans = [], []
        for e in events:
            kind = _kind(e)
            if kind in DEVICE_KINDS:
                device.append((kind, e))
            elif kind == "runtime":
                launch[e.correlation_id()] = _ns(e, "start") * 1e-9
            elif kind == "span":
                t = _ns(e, "start") * 1e-9
                spans.append(Span(e.name()[len(PREFIX):], t,
                                  t + _ns(e, "duration") * 1e-9))
        ops = []
        for kind, e in device:
            t = _ns(e, "start") * 1e-9
            ops.append(Op(e.name()[:NAME_CHARS], kind, t,
                          t + _ns(e, "duration") * 1e-9,
                          launch.get(e.correlation_id())))
        return cls(ops, spans)

    def _union(self) -> List[Tuple[float, float]]:
        """Device activity inside the window, as disjoint intervals."""
        out: List[List[float]] = []
        for op in sorted(self.ops, key=lambda o: o.start):
            a, b = max(op.start, self.start), min(op.end, self.end)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy)

    def _at(self, t: Optional[float]) -> Optional[int]:
        """The index of the span other than the window open at host time
        ``t``, None between spans. A driver's spans follow each other
        without nesting."""
        if t is None:
            return None
        i = bisect.bisect_right(self._starts, t) - 1
        return i if i >= 0 and self._inner[i].end >= t else None

    def span_at(self, t: Optional[float]) -> str:
        """The name of the span open at host time ``t`` (``loop`` between
        spans, ``unknown`` for an op with no launch record)."""
        if t is None:
            return "unknown"
        i = self._at(t)
        return "loop" if i is None else self._inner[i].name

    def count(self, name: str) -> int:
        return sum(1 for s in self.spans if s.name == name)

    def ops_named(self, part: str) -> List[Op]:
        return [o for o in self.ops if part in o.name and
                self.start <= o.start < self.end]

    def idle_gaps(self) -> Dict[str, float]:
        """Seconds of the window with nothing on the device, by the span
        the host was in."""
        out: Dict[str, float] = defaultdict(float)
        t = self.start
        for a, b in self._busy + [(self.end, self.end)]:
            if a > t:
                out[self.span_at((a + t) / 2)] += a - t
            t = max(t, b)
        return dict(out)

    def breakdown(self, n: int = 10) -> Dict[str, list]:
        by_op: Dict[str, float] = defaultdict(float)
        for o in self.ops:
            if self.start <= o.start < self.end:
                by_op[o.name] += o.end - o.start
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.idle_gaps().items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in gaps]}


class Tracer:
    """The spans and the traced slice of a run traced (``on``); both no-ops
    otherwise.

    The profiler runs from the window's start for ``traced_s`` seconds,
    or to its end where it is shorter: each traffic driver calls
    :meth:`tick` between its calls into the program, and the first tick
    past the slice's end stops the profiler. The slice holds thousands of
    batches or requests, and its trace is read after the window within
    the run's time limit. The readers divide by what the slice holds
    (its spans, its seconds), never by the whole window's counts.
    ``stopped`` is (the ticks so far, the host time) when the profiler
    stopped: a reader of the window after the slice starts there."""

    def __init__(self, on: bool, device: torch.device,
                 traced_s: float = TRACED_S):
        self.on = on
        self.device = device
        self.traced_s = traced_s
        self.trace: Optional[Trace] = None
        self._prof = self._span = None
        self._until = 0.0
        self.ticks = 0
        self.stopped: Optional[Tuple[int, float]] = None

    def span(self, name: str):
        if self._prof is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(PREFIX + name)

    @contextlib.contextmanager
    def window(self) -> Iterator[None]:
        """The measured window; its first ``traced_s`` profiled when on,
        as the span ``bench.window``."""
        if not self.on:
            yield
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        self._prof = prof
        self._span = self.span("window")
        self._span.__enter__()
        self._until = time.perf_counter() + self.traced_s
        try:
            yield
        finally:
            self._stop()
        self.trace = Trace.from_profiler(prof)

    def tick(self) -> None:
        """Count a call; end the traced slice once it has lasted
        ``traced_s``."""
        self.ticks += 1
        if self._prof is not None and time.perf_counter() >= self._until:
            self._stop()

    def _stop(self) -> None:
        if self._prof is None:
            return
        self._span.__exit__(None, None, None)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.stop()
        self._prof = None
        self.stopped = (self.ticks, time.perf_counter())
