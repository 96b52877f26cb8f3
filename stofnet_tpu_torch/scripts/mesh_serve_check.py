"""The mesh daemon over several devices against one device::

    python -m stofnet_tpu_torch.scripts.mesh_serve_check [--device cpu]
        [--dp 1 2 4] [--sp 1 2 4] [--length 8000 ...] [--batch 512 ...]
        [--requests 20]

Serves one seeded StofNet checkpoint in bf16 through ``cli/serve.py``
with ``mesh=True mesh_dp=N mesh_sp=M`` for each length, each batch and
each (N, M) of ``--dp`` x ``--sp`` (the first N * M cards, or N * M
replicas on the CPU), one request of the batch's rows at a time, so that
every request is one batch split into N slices, each row of a slice into
M shards. Prints a JSON line for each: ms a request and rows a second
over ``--requests`` requests after a warm-up request (host clock, client
to client), the kernel launches a request, and whether every row equals
the first mesh's of that length and batch bit for bit. Exits 1 where a
row differs. Writes nothing but a temporary checkpoint.
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
                    help="dp sizes (default: 1 and every card)")
    ap.add_argument("--sp", type=int, nargs="+", default=[1])
    ap.add_argument("--length", type=int, nargs="+", default=[8000])
    ap.add_argument("--batch", type=int, nargs="+", default=[512])
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    device = resolve_device(a.device)
    dps = a.dp or ([1, torch.cuda.device_count()] if device.type == "cuda"
                   else [1, 2])
    state = StofNet(generator=torch.Generator().manual_seed(a.seed),
                    device="cpu").state_dict()
    bad = False
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(Path(tmp) / "meshserve-seed0.pt", state)
        for length in a.length:
            for batch in a.batch:
                rows = gate_batch(batch, length,
                                  np.random.default_rng(a.seed))[:, 0]
                first = None
                for dp in dps:
                    for sp in a.sp:
                        reset_launch_counts()
                        got, ms = serve({
                            "model_file": "meshserve", "ckpt_dir": tmp,
                            "length": length, "dtype": "bfloat16",
                            "device": str(device), "mesh": True,
                            "mesh_dp": dp, "mesh_sp": sp,
                            "max_batch": batch, "max_wait_ms": 2,
                            "port": 0, "warmup": False}, rows, a.requests)
                        first = got if first is None else first
                        equal = bool(np.array_equal(got, first))
                        bad |= not equal
                        med = float(np.median(ms))
                        print(json.dumps({
                            "dp": dp, "sp": sp, "batch": batch,
                            "length": length, "ms_per_request": med,
                            "request_ms": ms,
                            "rows_per_s": batch / med * 1e3,
                            "launches_per_request": {
                                k: v / (a.requests + 1)
                                for k, v in launches().items()},
                            "rows_equal_first": equal}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
