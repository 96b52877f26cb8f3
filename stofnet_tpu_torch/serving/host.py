"""Dynamic-batching serving host for the RF→ToF pipeline (a copy of
``stofnet_tpu/serving/host.py``; numpy and the standard library only).

Requests arrive one or a few waveforms at a time, but the card earns its
throughput only at large batches. The host closes that gap with dynamic
batching:

- concurrent producers ``submit()`` waveforms and get a ``Future``;
- a single dispatcher thread coalesces queued requests until the batch
  is full or the oldest request has waited ``max_wait_ms``;
- the coalesced batch is zero-padded up to a power-of-two BUCKET and run
  through one pipeline call; results are sliced back per request.

Why buckets: the pipeline's launches, cuDNN's algorithm choices and the
kernels' first builds follow the batch shape, so padding to
``batch_buckets(max_batch)`` bounds the launch shapes at
log2(max_batch)+1 for at most 2x padding waste, and ``warmup()`` runs
every one of them before the server binds, so no client waits on a
first call.

Why padding is sound: every stage of the pipeline is row-local (convs,
SGB pooling, the static top-k decode, and the int8 path's per-waveform
activation scales, ``models/int8.py``), so zero rows cannot perturb real
rows: the same row decodes to the same bits at B=1, padded and in a full
batch (``tests/test_torch_serving.py``).

The ``pipeline`` argument is any ``f((B, 1, L) f32) -> (B, E)`` whose
result ``np.asarray`` takes (host numpy: ``cli/serve.py`` hands the host
a pipeline that copies its coords back from the card), or a test double.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np

_SENTINEL = object()


class Overloaded(RuntimeError):
    """Raised at submit when the host's ``max_pending`` admission limit
    is hit — the caller should shed load or retry with backoff. Reported
    in-band by the TCP front like any request error (the connection and
    the daemon keep working)."""


def batch_buckets(max_batch: int) -> Tuple[int, ...]:
    """Powers of two up to ``max_batch`` (plus ``max_batch`` itself when
    it is not one). The static-shape set the host pads batches into."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


class _Request:
    __slots__ = ("rows", "future", "t_submit", "squeeze")

    def __init__(self, rows: np.ndarray, squeeze: bool, t_submit: float):
        self.rows = rows
        self.future: Future = Future()
        self.t_submit = t_submit
        self.squeeze = squeeze


class ServingHost:
    """Coalesces concurrent waveform requests into padded static batches.

    Parameters
    ----------
    pipeline : callable ``(B, 1, L) f32 -> (B, E)``
    length : the static waveform length L of the serving contract
    max_batch : largest (bucketed) batch one pipeline call may carry
    max_wait_ms : how long the OLDEST queued request may wait for the
        batch to fill before dispatching anyway (the latency knob; 0
        dispatches immediately with whatever has queued)
    """

    def __init__(self, pipeline: Callable[[np.ndarray], Any], length: int,
                 *, max_batch: int = 128, max_wait_ms: float = 2.0,
                 buckets: Optional[Sequence[int]] = None,
                 max_pending: Optional[int] = None,
                 timer: Callable[[], float] = time.monotonic):
        self._pipeline = pipeline
        self.length = int(length)
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self._timer = timer
        # buckets override: e.g. (N,) for a pipeline that runs at one
        # batch size only
        self._buckets = (batch_buckets(self.max_batch) if buckets is None
                         else tuple(sorted(int(b) for b in buckets)))
        if not self._buckets or self._buckets[-1] != self.max_batch:
            raise ValueError(f"buckets {self._buckets} must end at "
                             f"max_batch={self.max_batch}")
        # admission control: max WAVEFORMS submitted but not yet resolved
        # (queued + in-flight — a slow device builds backlog both places);
        # None = unbounded (the closed-loop default; open-loop producers
        # should set it or the queue grows without bound under overload)
        self._max_pending = None if max_pending is None else int(max_pending)
        if (self._max_pending is not None
                and self._max_pending < self.max_batch):
            # a limit below max_batch would make a legal full-bucket
            # request permanently unadmittable even on an idle host, with
            # a misleading "queue full" — reject the config up front
            raise ValueError(
                f"max_pending={self._max_pending} < max_batch="
                f"{self.max_batch}: a full-batch request could never be "
                f"admitted; raise max_pending to at least max_batch")
        self._pending_rows = 0
        self._queue: "queue.Queue" = queue.Queue()
        self._closed = False
        self._lock = threading.Lock()
        self._stats: Dict[str, Any] = {
            "requests": 0, "waveforms": 0, "batches": 0, "padded": 0,
            "errors": 0, "rejected": 0,
            "bucket_counts": {b: 0 for b in self._buckets},
        }
        self._latencies: deque = deque(maxlen=4096)
        # per-batch pipeline call durations (queue wait excluded): a
        # throughput sag with flat call times lies on the host or the
        # client side, one with rising call times on the card's
        self._dispatch_s = 0.0
        self._dispatch_samples: deque = deque(maxlen=4096)
        self._thread = threading.Thread(
            target=self._dispatch_loop, daemon=True,
            name="stofnet-serving-dispatch")
        self._thread.start()

    # -------------------------------------------------- client surface
    def submit(self, x: np.ndarray) -> Future:
        """Enqueue waveforms; returns a Future resolving to the decoded
        coords. Accepts ``(L,)`` → ``(E,)``, ``(k, L)`` or ``(k, 1, L)``
        → ``(k, E)``. Shape errors raise here, not in the Future."""
        rows, squeeze = self._normalize(x)
        req = _Request(rows, squeeze, self._timer())
        # enqueue under the lock so no request can land behind close()'s
        # sentinel (which would leave its Future forever pending)
        with self._lock:
            if self._closed:
                raise RuntimeError("ServingHost is closed")
            k = rows.shape[0]
            if (self._max_pending is not None
                    and self._pending_rows + k > self._max_pending):
                self._stats["rejected"] += 1
                raise Overloaded(
                    f"serving queue full ({self._pending_rows} waveforms "
                    f"pending, max_pending={self._max_pending}); shed load "
                    f"or retry with backoff")
            self._pending_rows += k
            self._stats["requests"] += 1
            self._queue.put(req)
        return req.future

    def infer(self, x: np.ndarray, timeout: Optional[float] = None):
        """``submit`` + wait; the synchronous convenience call."""
        return self.submit(x).result(timeout)

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> None:
        """Run one zero batch per bucket (all buckets by default), so
        every launch shape has been built and run before a request
        arrives."""
        for b in (self._buckets if buckets is None else buckets):
            np.asarray(self._pipeline(
                np.zeros((b, 1, self.length), np.float32)))

    def stats(self) -> Dict[str, Any]:
        """Occupancy = real waveforms / padded waveforms actually run —
        the fraction of the card's work that served requests."""
        with self._lock:
            s = dict(self._stats)
            s["bucket_counts"] = dict(self._stats["bucket_counts"])
            s["pending"] = self._pending_rows
            lat = sorted(self._latencies)
            s["dispatch_time_s"] = self._dispatch_s
            disp = sorted(self._dispatch_samples)
        s["occupancy"] = (s["waveforms"] / s["padded"]) if s["padded"] else 0.0
        if lat:
            s["latency_p50_ms"] = 1e3 * lat[len(lat) // 2]
            s["latency_p99_ms"] = 1e3 * lat[min(len(lat) - 1,
                                                int(len(lat) * 0.99))]
        if disp:
            # pipeline call time alone (queue wait excluded); cumulative
            # dispatch_time_s + batches give per-window means
            s["dispatch_p50_ms"] = 1e3 * disp[len(disp) // 2]
            s["dispatch_p99_ms"] = 1e3 * disp[min(len(disp) - 1,
                                                  int(len(disp) * 0.99))]
        return s

    def close(self, timeout: Optional[float] = 60.0) -> None:
        """Stop accepting work, drain everything already queued, join the
        dispatcher. Idempotent."""
        with self._lock:
            already, self._closed = self._closed, True
            if not already:
                self._queue.put(_SENTINEL)
        self._thread.join(timeout)

    def __enter__(self) -> "ServingHost":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -------------------------------------------------- internals
    def _normalize(self, x: np.ndarray) -> Tuple[np.ndarray, bool]:
        x = np.asarray(x, np.float32)
        squeeze = x.ndim == 1
        if x.ndim == 1:
            x = x[None, None]
        elif x.ndim == 2:
            x = x[:, None]
        elif x.ndim != 3 or x.shape[1] != 1:
            raise ValueError(f"expected (L,), (k, L) or (k, 1, L), got "
                             f"shape {x.shape}")
        if x.shape[-1] != self.length:
            raise ValueError(f"waveform length {x.shape[-1]} != serving "
                             f"contract length {self.length}")
        if not (1 <= x.shape[0] <= self.max_batch):
            raise ValueError(f"request carries {x.shape[0]} waveforms; "
                             f"must be 1..max_batch={self.max_batch}")
        return x, squeeze

    def _dispatch_loop(self) -> None:
        carry: Optional[_Request] = None
        while True:
            first = carry if carry is not None else self._queue.get()
            carry = None
            if first is _SENTINEL:
                return
            batch = [first]
            rows = first.rows.shape[0]
            deadline = first.t_submit + self.max_wait_s
            stop = False
            while rows < self.max_batch:
                remaining = deadline - self._timer()
                try:
                    # past the deadline (incl. max_wait_ms=0) still scoop
                    # whatever is ALREADY queued — a slow device call
                    # builds a backlog, and the backlog should ride one
                    # coalesced batch, not dribble out as singles
                    nxt = (self._queue.get(timeout=remaining)
                           if remaining > 0 else self._queue.get_nowait())
                except queue.Empty:
                    break
                if nxt is _SENTINEL:
                    stop = True
                    break
                if rows + nxt.rows.shape[0] > self.max_batch:
                    carry = nxt  # never split one request across batches
                    break
                batch.append(nxt)
                rows += nxt.rows.shape[0]
            self._process(batch)
            if stop:
                # closed mid-coalesce: drain whatever was already queued
                while True:
                    try:
                        nxt = self._queue.get_nowait()
                    except queue.Empty:
                        return
                    if nxt is _SENTINEL:
                        return
                    self._process([nxt])

    def _process(self, batch) -> None:
        rows = np.concatenate([r.rows for r in batch])
        n = rows.shape[0]
        bucket = next(b for b in self._buckets if b >= n)
        if bucket > n:
            rows = np.concatenate(
                [rows, np.zeros((bucket - n, 1, self.length), np.float32)])
        t_pipe = self._timer()
        try:
            out = np.asarray(self._pipeline(rows))
        except Exception as e:  # noqa: BLE001 — fan the failure out
            with self._lock:
                self._stats["errors"] += 1
                self._pending_rows -= n
            for r in batch:
                r.future.set_exception(e)
            return
        done = self._timer()
        dispatch = done - t_pipe
        i = 0
        for r in batch:
            k = r.rows.shape[0]
            res = out[i:i + k]
            i += k
            r.future.set_result(res[0] if r.squeeze else res)
        with self._lock:
            self._stats["batches"] += 1
            self._stats["waveforms"] += n
            self._stats["padded"] += bucket
            self._stats["bucket_counts"][bucket] += 1
            self._pending_rows -= n
            self._latencies.extend(done - r.t_submit for r in batch)
            self._dispatch_s += dispatch
            self._dispatch_samples.append(dispatch)
