"""The program's own spans (``stofnet_tpu_torch.utils.profiling``), read
in the run's own process against the traced window: what the span
metrics (``metrics/<name>.py``) share.

The program stamps its spans with ``time.time_ns()``, the clock of the
profiler's events, so a span's interval lies on the trace's clock: the
readers compare it with the device activity of ``Trace.ops`` (kernels,
copies and fills) and with each op's launch time. A serving call is the
root span ``call`` holding ``h2d``, ``forward`` and ``decode``; the
set-up stages are ``kernels.build``, ``kernels.load`` and
``first_call``. Where the program keeps no records (none recorded, or a
program without ``recorded()``), every reader returns None.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Sequence, Tuple

DEVICE_WORK = ("kernel", "gpu_memset")  # what a span's launches count
KERNEL_SPANS = ("kernels.build", "kernels.load")


def records() -> Optional[list]:
    """The program's span records, or None where it keeps none."""
    from stofnet_tpu_torch.utils import profiling

    if not hasattr(profiling, "recorded"):
        return None  # a program from before its spans
    return profiling.recorded() or None


def window(rec, name: str) -> Optional[List[Tuple[float, float]]]:
    """The (start, end) seconds of the program's spans ``name`` inside the
    traced window, in start order; None without a trace or records, or
    with no such span in the window."""
    if rec.trace is None:
        return None
    found = records()
    if found is None:
        return None
    t = rec.trace
    out = sorted((r.start * 1e-9, r.end * 1e-9) for r in found
                 if r.name == name)
    out = [(a, b) for a, b in out if t.start <= a and b <= t.end]
    return out or None


def busy(rec) -> List[Tuple[float, float]]:
    """Device activity inside the traced window as disjoint intervals, in
    order."""
    t = rec.trace
    out: List[List[float]] = []
    for op in sorted(t.ops, key=lambda o: o.start):
        a, b = max(op.start, t.start), min(op.end, t.end)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def idle_ms(rec, name: str) -> Optional[float]:
    """ms a span ``name`` of the window, on average, during which nothing
    ran on the card: each span's interval less the part that the union of
    device activity covers."""
    spans = window(rec, name)
    if spans is None:
        return None
    union = busy(rec)
    ends = [b for _, b in union]
    idle = 0.0
    for a, b in spans:
        idle += b - a
        i = bisect.bisect_right(ends, a)  # the first interval ending after a
        while i < len(union) and union[i][0] < b:
            idle -= min(b, union[i][1]) - max(a, union[i][0])
            i += 1
    return 1e3 * idle / len(spans)


def launched_ms(rec, name: str, skip: Sequence[str] = ()
                ) -> Optional[float]:
    """Device ms a span ``name`` of the window, on average, of the kernels
    and fills (``DEVICE_WORK``) launched inside one (by the host time of
    the runtime call), less those whose name holds one of ``skip``."""
    spans = window(rec, name)
    if spans is None:
        return None
    t = rec.trace
    starts = [a for a, _ in spans]
    total = 0.0
    for o in t.ops:
        if (o.kind not in DEVICE_WORK or o.launched is None
                or not t.start <= o.start < t.end
                or any(k in o.name for k in skip)):
            continue
        i = bisect.bisect_right(starts, o.launched) - 1
        if i >= 0 and o.launched <= spans[i][1]:
            total += o.end - o.start
    return 1e3 * total / len(spans)


def setup(rec) -> Optional[list]:
    """The program's records that closed before the traced window (all of
    them without a trace): the run's set-up stages (``once`` records), in
    a process that runs one cell, among spans of other names."""
    found = records()
    if found is None or rec.trace is None:
        return found
    return [r for r in found if r.end <= rec.trace.start * 1e9]
