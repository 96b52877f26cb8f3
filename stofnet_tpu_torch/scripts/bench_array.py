"""Job arrays on the card: N members as one vmapped program against N
solo runs (replaces ``scripts/bench_array.py``)::

    python -m stofnet_tpu_torch.scripts.bench_array [--out FILE] \\
        [--device cpu --smoke]

Five times, each the median ms of a call after two warm-up calls, every
call on a batch staged on the device beforehand and used by no other call
next to it, and the peak device memory of each:

- ``solo_b32_train_ms``: one StofNet f32 train step at B=32 (a job-array
  row's batch);
- ``array4_b32_train_ms``: 4 members x B=32 as one vmapped step
  (``parallel/array.make_array_train_step``);
- ``solo_b128_train_ms``: one step at B=128, the 128 waveforms a step the
  array carries;
- ``eval_th1_ms``: the eval step (forward, decode at the per-row maximum,
  loss, metrics) at B=128;
- ``eval_th8_sweep_ms``: one forward decoded at 8 thresholds
  (``make_threshold_sweep_step``) at B=128.

The architecture is ``different-armadillo``'s (645,764 parameters, x4)
from seeded random weights at L=8000; ``--smoke`` cuts L to 800 and the
batches to 4 and 16 for a CPU run. Times are CUDA events on the card
(``ops/kernels/_timing.time_once``), the host clock elsewhere. Prints one
JSON object and writes it to ``--out`` (default
``build/bench_array.json``).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from stofnet_tpu_torch import resolve_device
from stofnet_tpu_torch.models import StofNet
from stofnet_tpu_torch.ops.kernels._timing import time_once
from stofnet_tpu_torch.parallel import (
    init_array_state, make_array_train_step, make_threshold_sweep_step,
)
from stofnet_tpu_torch.train import (
    LossConfig, make_eval_step, make_optimizer, make_train_step,
)

MEMBERS = 4
THRESHOLDS = (0.003, 0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0)
CFG = LossConfig(upsample_factor=4, max_echoes=8)


def staged(rng: np.random.Generator, k: int, b: int, length: int,
           device) -> List[tuple]:
    """``k`` batches of ``b`` noise frames (each row scaled to a peak of
    1) with GT echoes at 0.25 and 0.6875 of the length, on ``device``."""
    out = []
    for _ in range(k):
        x = rng.standard_normal((b, 1, length)).astype(np.float32)
        x /= np.abs(x).max(-1, keepdims=True)
        gs = np.tile(np.array([[0.25, 0.6875]], np.float32) * length,
                     (b, 1)) + 0.25
        gt = np.round(gs[:, None, :] * CFG.upsample_factor).astype(np.int32)
        out.append(tuple(torch.from_numpy(a).to(device)
                         for a in (x, gs, gt)))
    return out


def timed(fn, batches: List[tuple], device: torch.device,
          iters: int) -> Dict[str, float]:
    """Median ms of ``fn(*batch)`` over ``iters`` calls after two warm-up
    calls, cycling through ``batches``, and the peak memory in GB (None
    off the card)."""
    for args in batches[:2]:
        fn(*args)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ms = [time_once(fn, *batches[i % len(batches)], device=device)[1]
          for i in range(iters)]
    peak = (torch.cuda.max_memory_allocated() / 1e9
            if device.type == "cuda" else None)
    return {"ms": float(np.median(ms)), "peak_gb": peak}


def measure(device, length: int = 8000, b_row: int = 32, b_full: int = 128,
            iters: int = 8, seed: int = 0) -> Dict[str, object]:
    """The five readings of the module docstring, the derived ratios and
    rates, and the configuration."""
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    k = iters + 2
    row, full = (staged(rng, k, b, length, device) for b in (b_row, b_full))

    def build(g):
        return StofNet(generator=g, device=device)

    out: Dict[str, object] = {}
    for name, batches in (("solo_b32_train", row),
                          ("solo_b128_train", full)):
        model = build(torch.Generator().manual_seed(seed))
        opt, sched = make_optimizer(model.parameters(), steps_per_epoch=100)
        step = make_train_step(model, opt, sched, CFG)
        out[name] = timed(step, batches, device, iters)
    state = init_array_state(build, range(seed, seed + MEMBERS))
    opt, sched = make_optimizer(state.params.values(), steps_per_epoch=100)
    out["array4_b32_train"] = timed(
        make_array_train_step(state, opt, sched, CFG), row, device, iters)

    model = build(torch.Generator().manual_seed(seed))
    out["eval_th1"] = timed(make_eval_step(model, CFG), full, device, iters)
    sweep = make_threshold_sweep_step(model, CFG)
    ths = torch.tensor(THRESHOLDS, dtype=torch.float32, device=device)
    variables = model.state_dict()
    out["eval_th8_sweep"] = timed(
        lambda *b: sweep(variables, *b, ths), full, device, iters)

    res: Dict[str, object] = {f"{k}_ms": v["ms"] for k, v in out.items()}
    res.update({f"{k}_peak_gb": v["peak_gb"] for k, v in out.items()})
    res["array4_vs_4x_solo_speedup"] = (4 * res["solo_b32_train_ms"]
                                        / res["array4_b32_train_ms"])
    res["array4_wf_s"] = MEMBERS * b_row / res["array4_b32_train_ms"] * 1e3
    res["solo_b128_wf_s"] = b_full / res["solo_b128_train_ms"] * 1e3
    res["th8_vs_8x_th1_speedup"] = (len(THRESHOLDS) * res["eval_th1_ms"]
                                    / res["eval_th8_sweep_ms"])
    res["config"] = {"L": length, "iters": iters, "b_row": b_row,
                     "b_full": b_full, "members": MEMBERS,
                     "device": str(device)}
    return res


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="build/bench_array.json")
    p.add_argument("--device", default=None)
    p.add_argument("--smoke", action="store_true",
                   help="L=800, batches of 4 and 16, 2 timed calls")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    kw = (dict(length=800, b_row=4, b_full=16, iters=2) if args.smoke
          else {})
    res = measure(dev, **kw)
    if dev.type == "cuda":
        res["config"]["card"] = torch.cuda.get_device_name(dev)
    text = json.dumps(res, indent=1)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text + "\n")
    print(text)
    print(f"wrote {out}", file=sys.stderr)


if __name__ == "__main__":
    main()
