"""The host's share of an int8 artifact's call, against the direct int8
pipeline, on one device::

    python -m stofnet_tpu_torch.scripts.int8_artifact_host [--device cpu]
        [--batch 128] [--length 8000] [--calls 20]

A seeded StofNet (the default architecture) calibrated on a seeded
echo-bearing batch (``int8_calib=``), in bf16, default and with every
stack conv in s8: its batch-polymorphic artifact (``serve.
export_pipeline``, saved and loaded) against ``serve.make_pipeline`` on
the same rows. For each, over ``--calls`` calls after a warm-up, in
turns: ms a batch (host clock around the call and the coords' copy
back, a device sync before), and the host's ms of the forward's call
alone (``heatmap``, no sync: what the host spends issuing it, the
exported programs' input checks included). The coords must be equal.
Prints one JSON line per stack: the programs of the artifact's forward
(its manifest's stages; one where the forward is one program), the
medians and the package it imported, so that the script measures an
older checkout's package too (run it with ``PYTHONPATH`` at that
checkout). Writes nothing but a temporary artifact.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
import zipfile
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

import stofnet_tpu_torch
from stofnet_tpu_torch import resolve_device
from stofnet_tpu_torch.data.synthetic import gate_batch
from stofnet_tpu_torch.models.stofnet import StofNet
from stofnet_tpu_torch.serve import (
    MANIFEST, export_pipeline, load_pipeline, make_pipeline, save_pipeline,
)

STACK = tuple(range(2, 13))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _programs(path: Path) -> int:
    with zipfile.ZipFile(path) as z:
        return len(json.loads(z.read(MANIFEST)).get("stages") or [None])


def measure(run, x, rows, device, calls: int) -> dict:
    """``run``'s medians over ``calls`` calls: ms a batch and the host's
    ms of its forward's call."""
    run(rows)
    ms, host_ms = [], []
    for _ in range(calls):
        _sync(device)
        t0 = time.perf_counter()
        run(rows).cpu()
        ms.append((time.perf_counter() - t0) * 1e3)
        _sync(device)
        t0 = time.perf_counter()
        run.heatmap(x)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        _sync(device)
    return {"ms_per_batch": float(np.median(ms)),
            "host_ms": float(np.median(host_ms))}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--length", type=int, default=8000)
    ap.add_argument("--calls", type=int, default=20)
    a = ap.parse_args(argv)
    device = resolve_device(a.device)
    state = StofNet(generator=torch.Generator().manual_seed(0),
                    device="cpu").state_dict()
    calib = gate_batch(a.batch, a.length, np.random.default_rng(1))
    rows = gate_batch(a.batch, a.length, np.random.default_rng(2))
    x = torch.from_numpy(rows).to(device)
    with tempfile.TemporaryDirectory() as tmp:
        for stack in (None, STACK):
            kw = dict(device=device, int8_calib=calib,
                      int8_stack_layers=stack, max_echoes=8)
            direct = make_pipeline(state, {}, **kw)
            path = save_pipeline(Path(tmp) / "i8.pt2", export_pipeline(
                state, {}, "b", a.length, **kw))
            served = load_pipeline(path)
            res = {"package": str(Path(stofnet_tpu_torch.__file__).parent),
                   "stack": bool(stack), "programs": _programs(path),
                   "batch": a.batch, "length": a.length,
                   "device": (torch.cuda.get_device_name(device)
                              if device.type == "cuda" else "cpu")}
            for turn in range(2):  # artifact, direct, direct, artifact
                order = (("artifact", served), ("direct", direct))
                for label, run in order[::1 - 2 * turn]:
                    got = measure(run, x, rows, device, a.calls)
                    for k, v in got.items():
                        res.setdefault(f"{label}_{k}", []).append(v)
            res["rows_equal"] = bool(torch.equal(served(rows).cpu(),
                                                 direct(rows).cpu()))
            print(json.dumps(res), flush=True)
            if not res["rows_equal"]:
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
