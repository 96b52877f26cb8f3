"""Streaming-read probe of the card (replaces ``scripts/dma_probe.py``).

    python -m stofnet_tpu_torch.scripts.dma_probe

Runs on the CUDA device and raises without one. On a (1,024,000, 128) bf16
array (262 MB, drawn from a seeded numpy generator) it times the PyTorch
reduce ``sum(x.view(-1, 8, 128), 0)`` in f32, runs the canary (o = 2 x,
exact), then sweeps the probe kernel (``ops/kernels/dma_probe.py``) over
(rows per stage, stages) points. Each point is checked before it is
timed: its total within rtol 1e-3 of the PyTorch sum, each element of its
(8, 128) output within 64 f32 epsilons of the sum of its terms' magnitudes
of the plain version's (a reordered f32 sum stays far inside that, a
stage read twice or skipped does not), and two runs bitwise equal. Times are medians of CUDA
events over launches that cycle through 4 distinct copies of the input,
each larger than the 50 MB L2 cache, so no launch reads the previous
one's data from the cache. Prints one JSON line
``{"metric": "manual_dma_bandwidth", ...}`` with GB/s per point. A point
that fails to launch is named in the line with its error and the sweep
goes on; a wrong sum raises.
"""

from __future__ import annotations

import json
from typing import Dict, Tuple

import numpy as np
import torch

from stofnet_tpu_torch import default_device
from stofnet_tpu_torch.ops.kernels import dma_probe
from stofnet_tpu_torch.ops.kernels._timing import time_ms

N_ROWS = 128 * 8000  # the probe shape of the JAX script: 262 MB of bf16
# (rows per stage, stages): 32 KB to 160 KB of ring per CTA; the stage
# sizes divide N_ROWS = 2^13 * 125
POINTS: Tuple[Tuple[int, int], ...] = (
    (64, 2), (128, 2), (256, 2), (64, 4), (128, 4), (160, 4), (64, 8),
    (80, 8))
COPIES = 4
SEED = 0
SUM_RTOL = 1e-3  # total against the PyTorch sum (the JAX script's check)
# per element, relative to the sum of its terms' magnitudes: 64 f32 epsilons
ELEM_TOL = 64 * torch.finfo(torch.float32).eps


def torch_reduce(x: torch.Tensor) -> torch.Tensor:
    """The yardstick: one PyTorch call computing the probe's function."""
    return torch.sum(x.view(-1, dma_probe.GROUP, x.shape[1]), dim=0,
                     dtype=torch.float32)


def check_point(x: torch.Tensor, chunk_rows: int, n_buffers: int,
                total: float, magnitude: torch.Tensor) -> float:
    """Run one point twice and hold it to the checks of the module
    docstring; returns max|kernel - plain|. Raises AssertionError."""
    got = dma_probe.stream_probe(x, chunk_rows, n_buffers)
    again = dma_probe.stream_probe(x, chunk_rows, n_buffers)
    plain = dma_probe.stream_probe_reference(x, chunk_rows)
    torch.cuda.synchronize()
    key = point_key(chunk_rows, n_buffers)
    got_total = float(got.double().sum())
    if not np.isclose(got_total, total, rtol=SUM_RTOL):
        raise AssertionError(f"{key}: WRONG sum {got_total} vs {total}")
    err = (got - plain).abs()
    if not bool((err <= ELEM_TOL * magnitude).all()):
        raise AssertionError(f"{key}: an element is off the plain version's "
                             f"by more than {ELEM_TOL} of its terms' "
                             f"magnitudes (max {float(err.max())})")
    if not torch.equal(got, again):
        raise AssertionError(f"{key}: two runs on the same input differ")
    return float(err.max())


def point_key(chunk_rows: int, n_buffers: int) -> str:
    return f"cuda_c{chunk_rows}_b{n_buffers}"


def run(strict: bool = True) -> Dict:
    """The probe on the card: {"line": the JSON line's dict, "ms": per
    point, "max_abs_err": per point, "best": the fastest point's key,
    "plain_ms": the plain version at that point, "library_ms": the PyTorch
    reduce}. ``strict=False`` records a point that fails to launch in the
    line and goes on; ``strict`` raises."""
    dev = default_device()
    x = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        (N_ROWS, dma_probe.WIDTH), dtype=np.float32)).to(dev, torch.bfloat16)
    nbytes = x.numel() * x.element_size()
    copies = [(x + i,) for i in range(COPIES)]
    line: Dict = {"metric": "manual_dma_bandwidth",
                  "device": torch.cuda.get_device_name(dev),
                  "shape_gb": nbytes / 1e9}

    library_ms = time_ms(torch_reduce, copies)
    line["torch_reduce_gbps"] = nbytes / library_ms / 1e6

    ones = torch.ones((dma_probe.GROUP, dma_probe.WIDTH), device=dev)
    if not torch.equal(dma_probe.canary(ones), ones * 2):
        raise AssertionError("canary: 2 x differs from x * 2")

    total = float(x.double().sum())
    magnitude = torch_reduce(x.abs())
    ms, errs = {}, {}
    for chunk_rows, n_buffers in POINTS:
        key = point_key(chunk_rows, n_buffers)
        try:
            errs[key] = check_point(x, chunk_rows, n_buffers, total,
                                    magnitude)
        except RuntimeError as e:  # a refused launch (_build.check)
            if strict:
                raise
            line[key] = f"{type(e).__name__}: {str(e)[:100]}"
            continue
        ms[key] = time_ms(lambda xi, c=chunk_rows, b=n_buffers:
                          dma_probe.stream_probe(xi, c, b), copies)
        line[key] = nbytes / ms[key] / 1e6
    if not ms:
        raise RuntimeError("dma_probe: no sweep point launched")
    best = min(ms, key=ms.get)
    best_rows = dict(zip((point_key(*p) for p in POINTS), POINTS))[best][0]
    plain_ms = time_ms(lambda xi: dma_probe.stream_probe_reference(
        xi, best_rows), copies, iters=3)
    line["best"] = best
    return dict(line=line, ms=ms, max_abs_err=errs, best=best,
                plain_ms=plain_ms, library_ms=library_ms)


def main() -> None:
    print(json.dumps(run(strict=False)["line"]))


if __name__ == "__main__":
    main()
