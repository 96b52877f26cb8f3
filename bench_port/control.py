"""The readings that a configuration's limits are set from, on the card at
a batch cell's size, one process over many seeds (the benchmark's runs
never run it)::

    python3 bench_port/control.py --workload armadillo.batch128 \
        --seeds 11 12 13 [--controls]

For each seed, as a run of the cell makes them (the weights, the pool of
frames, a sample of ``sample_batches`` of its batches), the mean of the
rows' gaps (``coord_gap_mean``, ``check.py``) and their widest of:

- ``program``: the serving callable of ``make_pipeline``, the timed path;
- with ``--controls``, ``fp8``: the reference computed in fp8, serving in
  the program's place (the control); ``int8`` and ``int8_stack``, where
  the program's own int8 route, calibrated on the first batch, without
  and with every stack conv that the model file names
  (``int8_stack_layers``) in int8, or ``refused: ...`` where the program
  or the model file lacks the route; the faults ``half_left_out`` (the second
  half of every batch answered as nothing, as a call that left it out),
  ``answer_moved`` (every served position moved by 7.25 samples where it
  is produced) and ``row_moved`` (one row of each batch, drawn from the
  seed, moved so).

One JSON line a seed on standard output: each reading's ``mean`` and
``max`` over the sampled rows (the numbers compared) and ``min``, the
least a single row reads (for ``answer_moved``: the least that a fault
in one row would read).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench_port import check, harness, inputs  # noqa: E402

SHIFT = 7.25  # samples an answer is moved by


def faults(coords: np.ndarray, gen: np.random.Generator) -> dict:
    half = coords.copy()
    half[coords.shape[0] // 2:] = 0.0
    moved = np.where(coords != 0, coords + SHIFT, 0.0).astype(np.float32)
    one = coords.copy()
    row = gen.integers(coords.shape[0])
    one[row] = moved[row]
    return {"half_left_out": half, "answer_moved": moved, "row_moved": one}


def stats(gaps: np.ndarray) -> dict:
    return {"mean": float(gaps.mean()), "max": float(gaps.max()),
            "min": float(gaps.min())}


def readings(cfg, params, seed: int, device, controls: bool) -> dict:
    import torch
    from stofnet_tpu_torch.serve import make_pipeline

    batch, length = int(params["batch"]), cfg["length"]
    n = min(int(params["pool"]), int(params["sample_batches"]))
    frames = inputs.frames(int(params["pool"]) * batch, length,
                           inputs.rng(seed, "frames")).reshape(
                               -1, batch, 1, length)[:n]
    model = harness.model_file(cfg)
    weights = model.weights(cfg, seed, device)
    dtype = getattr(torch, cfg["dtype"])

    def gap(pipe, alter=None) -> dict:
        out = {}
        answers = [pipe(x).cpu().numpy() for x in frames]
        kinds = {"": answers}
        if alter:
            kinds, gen = {}, np.random.default_rng(seed)
            for a in answers:
                for k, v in faults(a, gen).items():
                    kinds.setdefault(k, []).append(v)
        for k, got in kinds.items():
            out[k] = stats(check.gaps(cfg, model, weights,
                                      list(zip(frames, got)), device))
        return out

    kw = dict(model_name=cfg["model"], dtype=dtype, device=device,
              **cfg["decode"])
    pipe = make_pipeline(weights, dict(cfg["overrides"]), **kw)
    row = {"seed": seed, "program": gap(pipe)[""]}
    if controls:
        row.update(gap(pipe, alter=True))
        row["fp8"] = stats(np.concatenate([
            check.control_gaps(cfg, model, weights, x, device)
            for x in frames]))
        for name in ("int8", "int8_stack"):
            try:
                stack = (model.int8_stack_layers(cfg)
                         if name == "int8_stack" else None)
                q = make_pipeline(weights, dict(cfg["overrides"]),
                                  int8_calib=frames[0],
                                  int8_stack_layers=stack, **kw)
                row[name] = gap(q)[""]
            except (AttributeError, ValueError, RuntimeError) as e:
                row[name] = f"refused: {e}"[:200]  # a route it lacks
    return row


def main(argv=None, device=None, shrink=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", action="store_true")
    args = ap.parse_args(argv)
    import torch

    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    _, cell, cfg = harness.cell_files(args.workload, bench)
    params = dict(cell["params"])
    for key, value in (shrink or {}).items():
        (cfg if key in cfg else params)[key] = value
    device = torch.device(device or "cuda")
    rows = []
    for seed in args.seeds:
        rows.append(readings(cfg, params, seed, device, args.controls))
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
