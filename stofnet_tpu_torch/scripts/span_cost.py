"""The cost of the program's spans (``utils/profiling``) in a serving
call, and their clock against the profiler's events, on one device::

    python -m stofnet_tpu_torch.scripts.span_cost [--device cpu]
        [--batch 128] [--length 8000] [--calls 200]

1. The spans' own cost: a pipeline (``serve._pipeline``) whose copy-in,
   forward and decode do nothing, against the same three calls bare in
   inference mode, host us a call (the median of five rounds of ten
   times ``--calls`` calls), with no profiler running and under
   ``torch.profiler``.
2. A seeded StofNet (the default architecture, bf16) serving
   (``--batch``, 1, ``--length``) frames, host ms a call with the coords
   back, with no profiler and under it; under it, the median and the
   widest distance in us between each span's record and its profiler
   event at either end (the two clocks; a record brackets its event),
   the program's events on the card's timeline (none: no
   shadow), and the share of the kernels, copies and fills whose launch
   lies inside some ``call`` span.

Prints one JSON line with the device's name. Writes nothing.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from stofnet_tpu_torch import resolve_device
from stofnet_tpu_torch.data.synthetic import gate_batch
from stofnet_tpu_torch.models.stofnet import StofNet
from stofnet_tpu_torch.serve import _pipeline, make_pipeline
from stofnet_tpu_torch.utils import profiling


def per_call_us(fn: Callable, x, calls: int) -> float:
    """The median over five rounds of host us a call of ``fn(x)``."""
    rounds = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(x)
        rounds.append((time.perf_counter() - t0) / calls * 1e6)
    return statistics.median(rounds)


def overhead(device: torch.device, calls: int, acts) -> dict:
    x = torch.zeros(1, device=device)
    nothing = lambda t: t  # noqa: E731
    spanned = _pipeline(nothing, nothing, device, load=nothing)
    spanned(x)  # the first call, a set-up stage
    bare = torch.inference_mode()(lambda t: nothing(nothing(nothing(t))))
    out = {}
    for on in (False, True):
        prof = profile(activities=acts) if on else None
        if prof is not None:
            prof.start()
        key = "on" if on else "off"
        out[f"bare_us_{key}"] = per_call_us(bare, x, calls)
        out[f"spanned_us_{key}"] = per_call_us(spanned, x, calls)
        if prof is not None:
            prof.stop()
    return out


def serving(device: torch.device, batch: int, length: int, calls: int,
            acts) -> dict:
    torch.manual_seed(0)
    state = {k: v.detach() for k, v in
             StofNet(device=device).state_dict().items()}
    pipe = make_pipeline(state, {}, device=device)
    frames = gate_batch(batch, length, np.random.default_rng(0))
    for _ in range(3):
        pipe(frames).cpu()

    def timed(n: int) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            pipe(frames).cpu()
        return (time.perf_counter() - t0) / n * 1e3

    out = {"route": pipe.route(length), "ms_off": timed(calls)}
    seen = {r.id for r in profiling.recorded()}
    with profile(activities=acts) as prof:
        out["ms_on"] = timed(calls)
    recs = [r for r in profiling.recorded() if r.id not in seen]
    events, launch, device_ops, shadows = {}, {}, [], 0
    # by device and name: a profiler may name no event kinds
    for e in prof.profiler.kineto_results.events():
        ours = e.name().startswith(profiling.PREFIX)
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            shadows += ours
            if not ours:
                device_ops.append(e.correlation_id())
        elif ours:
            events.setdefault(e.name()[len(profiling.PREFIX):], []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
        elif e.name().startswith("cu"):
            launch[e.correlation_id()] = e.start_ns()
    gaps, outside = [], 0
    for name, evs in events.items():
        mine = sorted((r.start, r.end) for r in recs if r.name == name)
        if len(mine) != len(evs):
            raise RuntimeError(f"{len(mine)} {name} records, {len(evs)} "
                               f"events")
        for (a, b), (c, d) in zip(mine, sorted(evs)):
            gaps += [c - a, b - d]
            outside += c < a or b < d
    out["clock_gap_us"] = {"median": statistics.median(gaps) / 1e3,
                           "max": max(gaps) / 1e3,
                           "records": len(gaps) // 2,
                           "not_bracketing": outside}
    roots = sorted((r.start, r.end) for r in recs if r.name == "call")
    starts = [a for a, _ in roots]
    inside = 0
    for corr in device_ops:
        t = launch.get(corr)
        i = np.searchsorted(starts, t, side="right") - 1 if t else -1
        inside += bool(i >= 0 and t <= roots[i][1])
    out["calls_traced"] = len(roots)
    out["shadows_on_card"] = shadows
    out["device_ops"] = len(device_ops)
    out["launched_in_call"] = inside / max(1, len(device_ops))
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--length", type=int, default=8000)
    ap.add_argument("--calls", type=int, default=200)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    out = {"device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           "torch": torch.__version__}
    out.update(overhead(device, args.calls * 10, acts))
    out.update(serving(device, args.batch, args.length, args.calls, acts))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
