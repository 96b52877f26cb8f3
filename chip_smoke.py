#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``stofnet_tpu_torch``) on one card.

    python3 chip_smoke.py

1. Builds the CUDA kernels from ``stofnet_tpu_torch/csrc`` (one ``nvcc``
   per source, in parallel) and prints the build time and the card.
2. Holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (B=128, L=8000, bf16 inputs from a seeded numpy
   generator; plain versions in f32 with TF32 off), with
   max|kernel - plain| <= 2e-2 * max|plain|, and times the kernel, the
   plain version and one PyTorch yardstick the port never calls (CUDA
   events, a different input each launch, median of 20).
3. Serves 4 fresh batches of 128 echo-bearing waveforms through
   ``serve.make_pipeline`` with a seeded random-init StofNet
   (different-armadillo architecture, x4), after one warm-up batch, and
   checks that both kernels launched on every batch and that >= 0.99 of
   the coords lie within 1 sample of the plain path's (the same forward
   through the plain versions). Prints the agreement over coord slots and
   over rows with a detection, ms per batch (median of the 4), witnesses
   of where decoded positions move (the plain path on the CPU, the StofNet
   module in bf16 and in f32), and device time by kernel over the 4
   batches served again under the profiler. Fails when the kernel path
   moves more rows against the plain path than twice those that the plain
   path moves between the card and the CPU (f32 summation order alone),
   plus 4.
4. Prints one ``{"kernels": [...]}`` line, the card's name and power
   limit, and as the last line ``{"ok": true, "device": {...}}``.

Any failure raises, and the script exits non-zero. It exits non-zero
without a CUDA device too.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from stofnet_tpu_torch.data.synthetic import gate_batch
from stofnet_tpu_torch.models import StofNet, stofnet_apply_reference
from stofnet_tpu_torch.ops.kernels import _build, conv_stack, sgb
from stofnet_tpu_torch.ops.kernels import reset_launch_counts
from stofnet_tpu_torch.ops.peaks import mask2coords
from stofnet_tpu_torch.serve import make_pipeline

B, L, UP = 128, 8000, 4
DECODE = dict(window_size=20, threshold=None, upsample_factor=UP,
              max_echoes=8)
SEED = 0
TOL = 2e-2  # max|kernel - plain| <= TOL * max|plain|: bf16 outputs
TIMED = 20
N_BATCHES = 4
AGREE_MIN = 0.99  # decoded-coord agreement rule of bench.py
ROW_NOISE = 4  # rows of counting noise allowed beside the summation witness
PEAK_BF16 = 989e12  # FLOP/s, H100 SXM dense bf16 (data sheet)
PEAK_HBM = 3.35e12  # B/s, H100 SXM HBM3 (data sheet)


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def time_ms(fn, args_list, iters: int = TIMED) -> float:
    """Median CUDA-event time of ``fn``, cycling through ``args_list`` so
    each launch reads another input than the one before."""
    for args in args_list[:2]:  # warm-up
        fn(*args)
    torch.cuda.synchronize()
    events = []
    for i in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args_list[i % len(args_list)])
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16 * 1e3, nbytes / PEAK_HBM * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def variants(t: torch.Tensor, n: int = 4):
    """``n`` distinct copies of a batch (rolled along the batch axis), each
    larger than the 50 MB L2 cache at the main path's shapes."""
    return [torch.roll(t, i, dims=0).contiguous() for i in range(n)]


def check_close(name: str, got: torch.Tensor, ref: torch.Tensor) -> float:
    torch.cuda.synchronize()
    err = float((got.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    log(f"{name}: max|kernel - plain| = {err:.6g}, max|plain| = {scale:.6g}")
    if not (got.shape == ref.shape and np.isfinite(err)
            and err <= TOL * scale):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version ({err} > {TOL} * {scale})")
    return err


def kernel_sgb(dev, rng, state) -> dict:
    """SGB contract+pool at the main path's shapes and types."""
    h = torch.from_numpy(rng.standard_normal((B, L, 64), np.float32)).to(
        dev, torch.bfloat16)
    w = state["semi_global_block.contract_conv.weight"].permute(2, 1, 0)
    w = w.to(torch.bfloat16).contiguous()  # (5, 64, 512)
    b = state["semi_global_block.contract_conv.bias"].to(torch.bfloat16)
    wt, bias = sgb.sgb_weights(w, b, torch.bfloat16)  # as make_pipeline does
    err = check_close("sgb_contract_pool",
                      sgb.sgb_contract_pool_prepared(h, wt, bias),
                      sgb.sgb_contract_pool_reference(h, w, b))

    hs = variants(h)
    ms = time_ms(lambda x: sgb.sgb_contract_pool_prepared(x, wt, bias),
                 [(x,) for x in hs])
    plain_ms = time_ms(lambda x: sgb.sgb_contract_pool_reference(x, w, b),
                       [(x,) for x in hs])
    # yardstick: cuDNN conv + pool + leaky in bf16 on channels-first copies
    hc = [(x.transpose(1, 2).contiguous(),) for x in hs]
    wc = w.permute(2, 1, 0).contiguous()
    library_ms = time_ms(lambda x: F.leaky_relu(F.max_pool1d(
        F.conv1d(x, wc, b, padding=2), sgb.POOL), 0.01), hc)
    f = w.shape[2]
    t, by = bound(2.0 * B * L * f * w.shape[0] * w.shape[1],
                  nbytes(h, w, b) + B * (L // sgb.POOL) * f * 2)
    return dict(name="sgb_contract_pool", route="cuda",
                source="stofnet_tpu_torch/csrc/sgb_contract_pool.cu",
                replaces="stofnet_tpu/ops/pallas/sgb_kernel.py:189",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=t,
                bound_by=by, library_ms=library_ms)


def kernel_stack(dev, rng, state) -> dict:
    """Fused conv stack at the main path's shapes and types."""
    h0 = torch.from_numpy(rng.standard_normal((B, L, 64), np.float32)).to(
        dev, torch.bfloat16)
    wts = conv_stack.stack_weights(state, torch.bfloat16)  # as make_pipeline
    err = check_close("conv_stack_fused",
                      conv_stack.conv_stack_fused_prepared(h0, wts),
                      conv_stack.conv_stack_fused_reference(h0, state))

    hs = variants(h0)
    ms = time_ms(lambda x: conv_stack.conv_stack_fused_prepared(x, wts),
                 [(x,) for x in hs])
    plain_ms = time_ms(
        lambda x: conv_stack.conv_stack_fused_reference(x, state),
        [(x,) for x in hs])
    # yardstick: the chain of 12 cuDNN convs in bf16, channels-first
    wb = {k: v.to(torch.bfloat16) for k, v in state.items()}

    def library(x):
        h = res = res1 = x
        for i in range(2, 12):
            y = F.conv1d(h, wb[f"conv{i}.weight"], wb[f"conv{i}.bias"],
                         padding=3)
            if i % 2:
                h = res = res + y
            else:
                h = F.leaky_relu(y, 0.01)
        h = res1 + F.conv1d(h, wb["conv12.weight"], wb["conv12.bias"],
                            padding=3)
        return F.conv1d(h, wb["conv_last.weight"], wb["conv_last.bias"],
                        padding=1)

    library_ms = time_ms(library, [(x.transpose(1, 2).contiguous(),)
                                   for x in hs])
    r = state["conv_last.weight"].shape[0]
    weights = [state[f"conv{i}.{p}"] for i in range(2, 13)
               for p in ("weight", "bias")]
    weights += [state["conv_last.weight"], state["conv_last.bias"]]
    t, by = bound(2.0 * B * L * (11 * 7 * 64 * 64 + 3 * 64 * r),
                  nbytes(h0, *weights) + B * L * r * 4)
    return dict(name="conv_stack_fused", route="cuda",
                source="stofnet_tpu_torch/csrc/conv_stack.cu",
                replaces="stofnet_tpu/ops/pallas/conv_stack_kernel.py:137",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=t,
                bound_by=by, library_ms=library_ms)


def slot_agreement(a: torch.Tensor, b: torch.Tensor) -> float:
    """Fraction of the coord slots within 1 sample (bench.py's rule)."""
    return float((a - b).abs().le(1.0).float().mean())


def row_agreement(a: torch.Tensor, b: torch.Tensor):
    """Over the rows with a detection in either: the fraction whose slots
    all lie within 1 sample, and the count of the others."""
    has = (a != 0).any(1) | (b != 0).any(1)
    ok = (a - b).abs().le(1.0).all(1)
    return float(ok[has].float().mean()), int((has & ~ok).sum())


def main_path(dev, state, rng):
    """make_pipeline over 4 fresh gate batches after one warm-up batch;
    launch counts per batch."""
    pipe = make_pipeline(state, {"upsample_factor": UP}, device=dev,
                         window_size=DECODE["window_size"],
                         threshold=DECODE["threshold"],
                         max_echoes=DECODE["max_echoes"])
    pipe(gate_batch(B, L, rng)).cpu()  # cuDNN's algorithm choice, not timed
    batches = [gate_batch(B, L, rng) for _ in range(N_BATCHES)]
    coords, batch_ms = [], []
    reset_launch_counts()
    for x in batches:
        before = (sgb.launches, conv_stack.launches)
        t0 = time.perf_counter()
        c = pipe(x).cpu()  # the copy to the host waits for the card
        batch_ms.append((time.perf_counter() - t0) * 1e3)
        after = (sgb.launches, conv_stack.launches)
        if not all(a > b for a, b in zip(after, before)):
            raise AssertionError(f"a kernel did not launch on this batch: "
                                 f"(sgb, conv_stack) {before} -> {after}")
        coords.append(c)
    launches = {"sgb_contract_pool": sgb.launches,
                "conv_stack_fused": conv_stack.launches}

    params = {k: v.to(dev) for k, v in state.items()}
    with torch.inference_mode():
        plain = torch.cat([mask2coords(stofnet_apply_reference(
            params, torch.from_numpy(x).to(dev)), **DECODE).cpu()
            for x in batches])
    got = torch.cat(coords)
    if got.shape != (N_BATCHES * B, DECODE["max_echoes"]) or not bool(
            torch.isfinite(got).all()):
        raise AssertionError(f"bad coords: shape {tuple(got.shape)}")
    if bool((got < 0).any() or (got > L).any()):
        raise AssertionError("coords outside [0, L]")
    agree = slot_agreement(got, plain)
    rows, moved = row_agreement(got, plain)
    ms = float(np.median(batch_ms))
    out = dict(coord_agreement=agree, row_agreement=rows, rows_moved=moved,
               rows=int(got.shape[0]),
               detections_per_row=float((got != 0).sum(1).float().mean()),
               ms_per_batch=ms, batch_ms=batch_ms,
               waveforms_per_s=B / ms * 1e3, launches=launches)
    log(f"main path: {json.dumps(out)}")
    if agree < AGREE_MIN:
        raise AssertionError(f"coord agreement {agree} < {AGREE_MIN}")
    wit = witness(dev, state, batches, got, plain)
    log(f"witness: {json.dumps(wit)}")
    base = wit["plain~plain_cpu"]["moved"]
    if moved > 2 * base + ROW_NOISE:
        raise AssertionError(
            f"the kernel path moves {moved} rows against the plain path, "
            f"more than twice the {base} that f32 summation order alone "
            f"moves (plain path on the CPU) plus {ROW_NOISE}")
    prof = profile_batches(pipe, batches)
    prof["idle_share_derived"] = 1.0 - prof["device_busy_ms"] / ms
    log(f"profile: {json.dumps(prof)}")
    return out


def witness(dev, state, batches, got, plain) -> dict:
    """Row agreement of the served coords with other forwards of the same
    batches, each a witness of where decoded positions move:

    - ``plain_cpu``: the plain path on the CPU. It rounds where the plain
      path on the card does and sums in another order, so what moves
      between the two is f32 summation order alone.
    - ``module_bf16``: the StofNet module in bf16, at flax's rounding
      points (after each conv and each bias add).
    - ``module_f32``: the StofNet module in f32 on the card (TF32 off),
      the model without bf16; held against the kernel path, the plain
      path and ``module_bf16``.
    """
    cpu_state = {k: v.cpu() for k, v in state.items()}
    m16 = StofNet(dtype=torch.bfloat16, device=dev)
    m32 = StofNet(device=dev)
    m16.load_state_dict(state)
    m32.load_state_dict(state)
    cpu, c16, c32 = [], [], []
    t0 = time.perf_counter()
    with torch.inference_mode():
        for x in batches:
            xc = torch.from_numpy(x)
            cpu.append(mask2coords(stofnet_apply_reference(cpu_state, xc),
                                   **DECODE))
            xd = xc.to(dev)
            c16.append(mask2coords(m16(xd), **DECODE).cpu())
            c32.append(mask2coords(m32(xd), **DECODE).cpu())
    cpu, c16, c32 = torch.cat(cpu), torch.cat(c16), torch.cat(c32)
    pairs = {"kernel~plain_cpu": (got, cpu), "plain~plain_cpu": (plain, cpu),
             "kernel~module_bf16": (got, c16),
             "kernel~module_f32": (got, c32), "plain~module_f32": (plain, c32),
             "module_bf16~module_f32": (c16, c32)}
    out = {}
    for name, (a, b) in pairs.items():
        rows, moved = row_agreement(a, b)
        out[name] = dict(rows=rows, moved=moved, slots=slot_agreement(a, b))
    out["seconds"] = time.perf_counter() - t0
    return out


def profile_batches(pipe, batches) -> dict:
    """Device time by kernel over the timed batches, served once more under
    the profiler: where a batch's time goes. Its wall time is the
    profiler's, so the idle share is derived against the unprofiled
    median."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for x in batches:
            pipe(x).cpu()
        wall_us = (time.perf_counter() - t0) * 1e6 / len(batches)
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict = {}
    for e in kern:  # names cut to 60 characters; sum what they merge
        name = e.key[:60]
        by_name[name] = (by_name.get(name, 0.0)
                         + e.self_device_time_total / len(batches))
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(batches=len(batches), profiled_wall_ms=wall_us / 1e3,
                device_busy_ms=busy_us / 1e3,
                top_ms={k: v / 1e3 for k, v in top})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    logs = _build.build_all(["sgb_contract_pool", "conv_stack"])
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    log(f"card: {card()}")

    state = StofNet(generator=torch.Generator().manual_seed(SEED),
                    device=dev).state_dict()
    rng = np.random.default_rng(SEED)
    kernels = [kernel_sgb(dev, rng, state), kernel_stack(dev, rng, state)]
    for k in kernels:
        log(f"{k['name']}: {k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, "
            f"library {k['library_ms']:.4f}, bound {k['bound_ms']:.4f} ms "
            f"by {k['bound_by']})")

    run = main_path(dev, state, rng)
    for k in kernels:
        k["launches"] = run["launches"][k["name"]]
        if k["launches"] < N_BATCHES:
            raise AssertionError(f"{k['name']} launched {k['launches']} "
                                 f"times in {N_BATCHES} batches")
    log(f"total: {time.perf_counter() - t_start:.1f} s")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys}
                                  for kern in kernels]}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
