"""The mesh daemon over several devices against one device::

    python -m stofnet_tpu_torch.scripts.mesh_serve_check [--device cpu]
        [--dp 1 2 4] [--sp 1 2 4] [--length 8000 ...] [--batch 512 ...]
        [--requests 20] [--model stofnet ...]

Serves one seeded checkpoint of each ``--model`` family (StofNet by
default; the zoo at the driver's chirp arguments, rf_scale_factor 4 and,
for Kuleshov, sample_num L / 4) in bf16 through ``cli/serve.py`` with
``mesh=True mesh_dp=N mesh_sp=M`` for each length, each batch and each
(N, M) of ``--dp`` x ``--sp`` (the first N * M cards, or N * M replicas
on the CPU), one request of the batch's rows at a time, so that every
request is one batch split into N slices, each row of a slice into M
shards. Prints a JSON line for each: ms a request and rows a second over
``--requests`` requests after a warm-up request (host clock, client to
client), the kernel launches a request, whether every row equals the
first mesh's of that length and batch bit for bit, and the share of its
slots within 1 sample of them (Zonzini's ToA: within
:data:`ZONZINI_RTOL`). Exits 1
where that share is below 0.99. Writes nothing but temporary
checkpoints.
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
from stofnet_tpu_torch.models.registry import build_model
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
    ap.add_argument("--model", nargs="+", default=["stofnet"])
    a = ap.parse_args(argv)
    device = resolve_device(a.device)
    dps = a.dp or ([1, torch.cuda.device_count()] if device.type == "cuda"
                   else [1, 2])
    bad = False
    with tempfile.TemporaryDirectory() as tmp:
        for name in a.model:
            for length in a.length:
                args = checkpoint_args(name, length, a.seed, tmp)
                for batch in a.batch:
                    rows = gate_batch(batch, length,
                                      np.random.default_rng(a.seed))[:, 0]
                    first = None
                    for dp in dps:
                        for sp in a.sp:
                            reset_launch_counts()
                            got, ms = serve({
                                **args, "length": length,
                                "dtype": "bfloat16", "device": str(device),
                                "mesh": True, "mesh_dp": dp, "mesh_sp": sp,
                                "max_batch": batch, "max_wait_ms": 2,
                                "port": 0, "warmup": False}, rows,
                                a.requests)
                            first = got if first is None else first
                            share = agreement(name, got, first)
                            bad |= share < 0.99
                            med = float(np.median(ms))
                            print(json.dumps({
                                "model": name, "dp": dp, "sp": sp,
                                "batch": batch, "length": length,
                                "ms_per_request": med, "request_ms": ms,
                                "rows_per_s": batch / med * 1e3,
                                "launches_per_request": {
                                    k: v / (a.requests + 1)
                                    for k, v in launches().items()},
                                "rows_equal_first": bool(
                                    np.array_equal(got, first)),
                                "agreement_first": share}), flush=True)
    return 1 if bad else 0


def checkpoint_args(name: str, length: int, seed: int, tmp: str) -> dict:
    """The daemon's checkpoint arguments of a seeded draw of family
    ``name`` at ``length``, its checkpoint written under ``tmp``."""
    args = {"model": name, "ckpt_dir": tmp}
    if name == "stofnet":
        state = StofNet(generator=torch.Generator().manual_seed(seed),
                        device="cpu").state_dict()
    else:
        kw = dict(dataset_kind="chirp", upsample_factor=4,
                  rf_scale_factor=4, fs=1e6, sample_num=length // 4)
        args.update(kw, th="Null")
        if name != "kuleshov":
            args.pop("sample_num")
        if name == "gradpeak":
            return args
        state = build_model(name, generator=torch.Generator().manual_seed(
            seed), device="cpu", **kw)[0].state_dict()
    prefix = f"meshserve-{name}-{length}"
    save_checkpoint(Path(tmp) / f"{prefix}-seed{seed}.pt", state)
    args["model_file"] = prefix
    return args


# Zonzini's ToA, JAX's gate for a reduction summed in another order (its
# pool sums in f64 and rounds once, so a sharded pool has the bits of the
# single forward's, bf16 too: ``models/zonzini.py``)
ZONZINI_RTOL = 1e-4


def agreement(name: str, got: np.ndarray, first: np.ndarray) -> float:
    """The share of the slots within 1 sample of ``first``'s (Zonzini's
    ToA within :data:`ZONZINI_RTOL`)."""
    if name == "zonzini":
        return float(np.mean(np.abs(got - first)
                             <= ZONZINI_RTOL * np.abs(first)))
    return float(np.mean(np.abs(got - first) <= 1.0))

if __name__ == "__main__":
    sys.exit(main())
