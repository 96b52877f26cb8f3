"""Closed loop of full batches: host numpy frames through the serving
callable that ``stofnet_tpu_torch.serve.make_pipeline`` returns, coords
back on the host, the next batch sent when the last one's coords are
there.

Parameters: ``batch`` rows a call; ``pool`` distinct batches made from
the seed in set-up and sent in turn (each 4 MB at B=128, L=8000: more
than the card's 50 MB L2 together); ``warmup`` calls in set-up;
``sample_batches`` distinct batches of the pool checked once the window
has closed, each at one of the window's calls that sent it (``samples``).

The pipeline serves the configuration's ``model`` (``make_pipeline``'s
``model_name``). Each call is the entry ``pipe(x)`` (the copy to the
card, the forward and the decode) under the span ``pipe``, then the copy
of the coords to the host under ``host_leg``. The route guard: the
pipeline's route at the configuration's length is the configuration's,
and every call launches the configuration's kernels a batch, in set-up
and over the window. The span guard, in a traced run: every device op
launched inside ``pipe`` lies in one of the program's ``h2d``,
``forward`` and ``decode`` spans (``spans.uncovered``), which the span
readers split the call's device time by.
"""

from __future__ import annotations

import time

import numpy as np

from bench_port import inputs, spans
from bench_port.route import check_launches, expected_launches, launch_counts


def build_pipeline(ctx):
    import torch
    from stofnet_tpu_torch.serve import make_pipeline

    cfg = ctx.config
    pipe = make_pipeline(ctx.weights, dict(cfg["overrides"]),
                         model_name=cfg["model"],
                         dtype=getattr(torch, cfg["dtype"]),
                         device=ctx.device, **cfg["decode"])
    route = pipe.route(cfg["length"])
    if route != cfg["route"]:
        raise RuntimeError(f"route guard: the pipeline takes the {route} "
                           f"route at L={cfg['length']}, the configuration "
                           f"states {cfg['route']}")
    return pipe


class Run:
    def __init__(self, ctx):
        p, length = ctx.params, ctx.config["length"]
        self.ctx, self.batch = ctx, int(p["batch"])
        self.frames = inputs.frames(
            int(p["pool"]) * self.batch, length,
            inputs.rng(ctx.seed, "frames")).reshape(
                int(p["pool"]), self.batch, 1, length)
        ctx.log("frames")
        self.pipe = build_pipeline(ctx)
        ctx.log("pipeline")
        self.per = expected_launches(ctx)
        before = launch_counts()
        for i in range(int(p["warmup"])):
            self.call(self.frames[i % len(self.frames)])
        check_launches(before, self.per, int(p["warmup"]), "warm-up")
        ctx.log("warm-up")
        self.outs = []

    def call(self, x: np.ndarray) -> np.ndarray:
        span = self.ctx.tracer.span
        with span("pipe"):
            coords = self.pipe(x)
        with span("host_leg"):
            return coords.cpu().numpy()

    def close(self) -> None:
        self.pipe = None


def setup(ctx) -> Run:
    return Run(ctx)


def measure(run: Run) -> dict:
    before = launch_counts()
    n, pool = 0, len(run.frames)
    with run.ctx.tracer.window():
        t0 = time.perf_counter()
        deadline = t0 + run.ctx.seconds
        while True:
            run.outs.append(run.call(run.frames[n % pool]))
            run.ctx.tracer.tick()
            n += 1
            now = time.perf_counter()
            if now >= deadline:
                break
    check_launches(before, run.per, n, "window")
    stray = spans.uncovered(run.ctx.tracer.trace, "pipe")
    if stray:
        raise RuntimeError(
            f"span guard: {len(stray)} device ops launched inside pipe "
            f"outside the program's h2d, forward and decode spans, such as "
            f"{stray[0].name}: the span readers would miss their time")
    return {"seconds": now - t0, "end": now, "batches": n,
            "waveforms": n * run.batch, "attempted": n, "failed": 0}


def samples(run: Run, gen: np.random.Generator):
    """Distinct batches of the pool, drawn from the seed alone, each at
    one of the window's calls that sent it, drawn from the seed: so the
    same seed checks the same frames whatever the window's length."""
    n, pool = len(run.outs), len(run.frames)
    size = min(n, pool, int(run.ctx.params["sample_batches"]))
    batches = gen.choice(min(n, pool), size=size, replace=False)
    calls = [j + pool * int(gen.integers((n - 1 - j) // pool + 1))
             for j in batches]
    return [(run.frames[i % pool], run.outs[i]) for i in sorted(calls)], 0
