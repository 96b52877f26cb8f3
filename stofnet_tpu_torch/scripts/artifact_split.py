"""Where a serving request's time goes, piece by piece, on one device::

    python -m stofnet_tpu_torch.scripts.artifact_split [--device cpu]
        [--batch 128 512] [--length 8000] [--reps 10]
        [--enc-length 8000 160000] [--enc-batch 128] [--sp 1 2 4]
        [--trace]

A seeded StofNet (the default architecture, bf16) serves the same
echo-bearing rows (``data/synthetic.gate_batch``) three ways, as the
daemon's replica at sp = 1 calls each (``raw_call`` on the host
encoder's f32 inputs):

- ``checkpoint``: ``serve.make_pipeline``;
- ``artifact``: its batch-polymorphic artifact of two programs
  (``serve.export_pipeline``, saved and loaded), the forward and then
  the decode;
- ``one_program``: the same pipeline traced as one program, the layout
  of an artifact written before the forward and the decode were
  exported apart (``load_pipeline``'s path for it).

For each ``--batch`` at ``--length``, each call's host time is split,
with a device synchronization after each piece, into the host's encode,
the copy to the device, the forward (or the one program), the decode
and the coords' copy back; and each call is also timed whole, unsplit.
The routes take turns; medians over ``--reps`` calls. Their coords must
be equal. ``--trace``: ``torch.profiler`` over one call of each at each
batch, the device's busy ms, the number of device kernels and the five
that take most of the time.

Then, for each ``--enc-length``, ``--sp`` and input encoding (f32 and
s8c16), the host side of the daemon's length-sharded route
(``cli/serve._mesh_adjust``) for ``--enc-batch`` rows, its replicas on
the one device: the host's encode of the slice, and for each shard
``serve.encoded_window``'s slice, the copy of the window's codes and
scales to the device, the dequantization there (s8c: each position's
chunk scale gathered), the forward on the window; then the join and the
decode. Each piece's ms (summed over the shards) a request and the
bytes copied. Prints one JSON line per measurement and writes nothing.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from stofnet_tpu_torch import resolve_device
from stofnet_tpu_torch.data.synthetic import gate_batch
from stofnet_tpu_torch.models.stofnet import StofNet
from stofnet_tpu_torch.ops.conv import full_f32
from stofnet_tpu_torch.parallel import seq
from stofnet_tpu_torch.serve import (
    _trace, dequantize, encoded_input_specs, encoded_window, export_pipeline,
    load_pipeline, make_input_encoder, make_pipeline, parse_input_enc,
    save_pipeline,
)
from stofnet_tpu_torch.serving.codecs import chunk_len

DECODE = dict(window_size=20, threshold=None, max_echoes=64)


class Clock:
    """Host ms of named pieces, each ended by a device synchronization."""

    def __init__(self, device: torch.device):
        self.device, self.ms = device, {}

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def piece(self, name: str):
        self.sync()
        t0 = time.perf_counter()
        yield
        self.sync()
        self.ms[name] = self.ms.get(name, 0.0) + (
            time.perf_counter() - t0) * 1e3


def routes(state, length: int, device: torch.device, tmp: str
           ) -> Dict[str, Dict[str, Callable]]:
    """The three routes' pieces: ``forward`` (x on the device ->
    heatmap, or the one program's coords) and ``decode`` (None where the
    forward gives the coords)."""
    pipe = make_pipeline(state, {}, device=device, **DECODE)
    art = load_pipeline(save_pipeline(
        Path(tmp) / "two.pt2", export_pipeline(state, {}, "b", length,
                                               device=device, **DECODE)))
    examples, dynamic = encoded_input_specs(None, "b", length, device)
    one_path = Path(tmp) / "one.pt2"
    torch.export.save(_trace(pipe, examples, dynamic), str(one_path))
    one = load_pipeline(one_path)
    return {"checkpoint": {"forward": pipe.heatmap, "decode": pipe.decode},
            "artifact": {"forward": art.heatmap, "decode": art.decode,
                         "whole": art},
            "one_program": {"forward": one.raw_call, "decode": None,
                            "whole": one}}


def split_call(route: Dict[str, Callable], x: np.ndarray, clock: Clock,
               encode: Callable) -> np.ndarray:
    """One call of ``route`` on ``x``, piece by piece."""
    with clock.piece("encode"):
        coded = encode(x)[0]
    with clock.piece("copy_in"):
        xd = torch.as_tensor(coded).to(clock.device)
    with clock.piece("forward"), torch.inference_mode(), full_f32():
        out = route["forward"](xd)
    if route["decode"] is not None:
        with clock.piece("decode"), torch.inference_mode(), full_f32():
            out = route["decode"](out)
    with clock.piece("copy_out"):
        return out.cpu().numpy()


def whole_call(route: Dict[str, Callable], x: np.ndarray, clock: Clock,
               encode: Callable) -> np.ndarray:
    """One unsplit call: the loaded artifact as the daemon calls it, the
    checkpoint's pipeline on the encoded rows."""
    with clock.piece("whole"):
        if "whole" in route:
            return np.asarray(route["whole"](x).cpu())
        with torch.inference_mode(), full_f32():
            xd = torch.as_tensor(encode(x)[0]).to(clock.device)
            out = route["decode"](route["forward"](xd))
        return out.cpu().numpy()


def trace(route: Dict[str, Callable], x: np.ndarray, clock: Clock,
          encode: Callable) -> dict:
    """``torch.profiler`` over one split call: the device's busy ms, its
    kernels and the five that take most of the time."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if clock.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        split_call(route, x, clock, encode)
    wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time for e in kernels) / 1e3
    by = {}
    for e in kernels:
        by[e.name] = by.get(e.name, 0.0) + e.device_time / 1e3
    top = sorted(by.items(), key=lambda kv: -kv[1])[:5]
    return {"wall_ms": wall, "device_busy_ms": busy,
            "device_kernels": len(kernels),
            "top_ms": [[k[:80], v] for k, v in top]}


def pieces(a: argparse.Namespace, state, device: torch.device,
           tmp: str) -> None:
    """The three routes, split and whole, at each ``--batch``."""
    rs = routes(state, a.length, device, tmp)
    encode = make_input_encoder("f32")
    for batch in a.batch:
        rng = np.random.default_rng(a.seed + batch)
        rows = [gate_batch(batch, a.length, rng) for _ in range(a.reps)]
        for r in rs.values():  # cuDNN's choice and the kernels' builds
            whole_call(r, rows[0], Clock(device), encode)
        split = {k: [] for k in rs}
        whole = {k: [] for k in rs}
        coords = {}
        for x in rows:
            for name, r in rs.items():
                clock = Clock(device)
                coords[name] = split_call(r, x, clock, encode)
                split[name].append(clock.ms)
                clock = Clock(device)
                whole_call(r, x, clock, encode)
                whole[name].append(clock.ms["whole"])
        equal = all(np.array_equal(c, coords["checkpoint"])
                    for c in coords.values())
        for name in rs:
            med = {k: float(np.median([m[k] for m in split[name]]))
                   for k in split[name][0]}
            line = {"part": "routes", "route": name, "batch": batch,
                    "length": a.length, "split_ms": med,
                    "split_sum_ms": sum(med.values()),
                    "whole_ms": float(np.median(whole[name])),
                    "whole_ms_each": whole[name],
                    "coords_equal": equal}
            if a.trace:
                line["trace"] = trace(rs[name], rows[0], Clock(device),
                                      encode)
            print(json.dumps(line), flush=True)


def window_route(a: argparse.Namespace, state, device: torch.device
                 ) -> None:
    """The length-sharded route's host side, piece by piece."""
    for length in a.enc_length:
        pipe = make_pipeline(state, {}, device=device, **DECODE)
        arch = pipe.arch
        rng = np.random.default_rng(a.seed + length)
        rows = [gate_batch(a.enc_batch, length, rng)
                for _ in range(a.reps + 1)]
        for sp in a.sp:
            for enc in ("f32", "s8c16"):
                encode = make_input_encoder(enc)
                runs = []
                for x in rows:
                    clock = Clock(device)
                    copied = window_request(x, enc, encode, sp, arch, pipe,
                                            clock)
                    runs.append(clock.ms)
                runs = runs[1:]  # the first builds and warms
                med = {k: float(np.median([m[k] for m in runs]))
                       for k in runs[0]}
                print(json.dumps({
                    "part": "windows", "length": length, "sp": sp,
                    "input_enc": enc, "batch": a.enc_batch,
                    "split_ms": med, "split_sum_ms": sum(med.values()),
                    "bytes_copied": copied}), flush=True)


def window_request(x: np.ndarray, enc: str, encode: Callable, sp: int,
                   arch: dict, pipe: Callable, clock: Clock) -> int:
    """One request of the sharded route on ``clock``; the bytes copied.
    The dequantization is :func:`serve.dequantize`'s, split into its copy
    and its gather, and held to it bit for bit."""
    kind, n = parse_input_enc(enc)
    length = x.shape[-1]
    with clock.piece("encode"):
        coded = encode(x)
    outs: List[torch.Tensor] = []
    copied = 0
    for k in range(sp):
        shard = seq.shard_of(arch, length, sp, k, None)
        lo, hi = shard.window or shard.own
        with clock.piece("window_slice"):
            part = encoded_window(coded, enc, lo, hi)
        copied += sum(int(p.nbytes) for p in part)
        with clock.piece("copy_in"):
            on = [torch.as_tensor(p).to(device=clock.device) for p in part]
        with clock.piece("dequantize"):
            codes = on[0].to(torch.float32)
            if kind == "s8c":
                cl = chunk_len(length, n)
                pos = torch.arange(lo, lo + codes.shape[-1],
                                   device=clock.device)
                codes = codes * on[1][..., pos // cl - lo // cl]
        assert torch.equal(codes, dequantize(part, enc, lo, length,
                                             clock.device))
        with clock.piece("forward"):
            outs.append(seq.own_output(arch, pipe.heatmap(codes), shard))
    with clock.piece("join_decode"):
        coords = pipe.decode(torch.cat(outs, dim=-1))
    with clock.piece("copy_out"):
        coords.cpu().numpy()
    return copied


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--batch", type=int, nargs="+", default=[128, 512])
    ap.add_argument("--length", type=int, default=8000)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--enc-length", type=int, nargs="+",
                    default=[8000, 160000])
    ap.add_argument("--enc-batch", type=int, default=128)
    ap.add_argument("--sp", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", action="store_true")
    a = ap.parse_args(argv)
    device = resolve_device(a.device)
    state = StofNet(generator=torch.Generator().manual_seed(a.seed),
                    device="cpu").state_dict()
    with tempfile.TemporaryDirectory() as tmp:
        pieces(a, state, device, tmp)
    window_route(a, state, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
