"""The mesh daemon over several devices against one device::

    python -m stofnet_tpu_torch.scripts.mesh_serve_check [--device cpu]
        [--dp 1 2 4] [--length 8000] [--batch 512] [--requests 20]

Serves one seeded StofNet checkpoint in bf16 through ``cli/serve.py``
with ``mesh=True mesh_dp=N`` for each N of ``--dp`` (the first N cards,
or N replicas on the CPU), one request of ``--batch`` rows at a time, so
that every request is one batch split into N slices. Prints a JSON line
for each N: ms a request and rows a second over ``--requests`` requests
after a warm-up request (host clock, client to client), the kernel
launches of the run, and whether every row equals the first N's bit for
bit. Exits 1 where a row differs. Writes nothing but a temporary
checkpoint.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from stofnet_tpu_torch import resolve_device
from stofnet_tpu_torch.cli.serve import build
from stofnet_tpu_torch.data.synthetic import gate_batch
from stofnet_tpu_torch.models.stofnet import StofNet
from stofnet_tpu_torch.ops.kernels import KERNEL_MODULES, reset_launch_counts
from stofnet_tpu_torch.serving import ServingClient
from stofnet_tpu_torch.train.checkpoint import save_checkpoint


def launches() -> dict:
    """The kernel launch counters that moved, as ``module.counter``."""
    out = {f"{mod.__name__.rsplit('.', 1)[1]}.{c}": getattr(mod, c)
           for mod in KERNEL_MODULES for c in mod.COUNTERS}
    return {k: v for k, v in out.items() if v}


def serve(args: dict, rows: np.ndarray, requests: int):
    """The daemon of ``args``: a warm-up request of ``rows``, then
    ``requests`` timed ones; (the last coords, ms of each request)."""
    hostd, server, port = build(args)
    try:
        with ServingClient(("127.0.0.1", port)) as client:
            got = np.asarray(client.infer(rows))
            ms = []
            for _ in range(requests):
                t0 = time.perf_counter()
                got = np.asarray(client.infer(rows))
                ms.append((time.perf_counter() - t0) * 1e3)
        return got, ms
    finally:
        server.shutdown()
        server.server_close()
        hostd.close()


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--dp", type=int, nargs="+", default=None,
                    help="mesh sizes (default: 1 and every card)")
    ap.add_argument("--length", type=int, default=8000)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    device = resolve_device(a.device)
    dps = a.dp or ([1, torch.cuda.device_count()] if device.type == "cuda"
                   else [1, 2])
    rows = gate_batch(a.batch, a.length,
                      np.random.default_rng(a.seed))[:, 0]
    state = StofNet(generator=torch.Generator().manual_seed(a.seed),
                    device="cpu").state_dict()
    first, bad = None, False
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(Path(tmp) / "meshserve-seed0.pt", state)
        for dp in dps:
            reset_launch_counts()
            got, ms = serve({
                "model_file": "meshserve", "ckpt_dir": tmp,
                "length": a.length, "dtype": "bfloat16",
                "device": str(device), "mesh": True, "mesh_dp": dp,
                "max_batch": a.batch, "max_wait_ms": 2, "port": 0,
                "warmup": False}, rows, a.requests)
            first = got if first is None else first
            equal = bool(np.array_equal(got, first))
            bad |= not equal
            med = float(np.median(ms))
            print(json.dumps({
                "dp": dp, "batch": a.batch, "length": a.length,
                "ms_per_request": med, "request_ms": ms,
                "rows_per_s": a.batch / med * 1e3, "launches": launches(),
                "rows_equal_first": equal}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
