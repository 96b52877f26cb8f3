#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``stofnet_tpu_torch``) on one card.

    python3 chip_smoke.py

1. Builds the four CUDA sources of ``stofnet_tpu_torch/csrc`` (one
   ``nvcc`` per source, in parallel), prints the build time and the card,
   and runs the canary (o = 2 x on (8, 128) f32) before any other kernel:
   it must equal ``x * 2`` bit for bit, so a failure there names the
   toolchain or the CUDA runtime, not a kernel. Its launch route is read
   three ways beside ``torch.mul``'s (the ``canary launch route`` line, us
   a call): CUDA events around one call (its kernels-line time), the host
   clock over 1,000 calls back to back with no synchronise, and the
   kernel's device time under the profiler over 100 calls.
2. Holds each kernel against its plain PyTorch version on the card at the
   shapes its path gives it (B=128, L=8000; JAX's ``sgb_contract_pool``
   counterpart at L_UNCHUNKED=2000, a serving length JAX's DMA kernel
   refuses; bf16 inputs from a seeded numpy generator; plain versions in
   f32 with TF32 off), with max|kernel - plain| <= 2e-2 * max|plain|, and
   times the kernel, the plain version and one PyTorch yardstick the port
   never calls (CUDA events, a different input each launch, median of
   20). Both of JAX's serving SGB kernels have one counterpart, the
   serving instantiation of the streamed kernel (``wgmma``, on the weight
   image of ``sgb_dma_weights``): its ``sgb_contract_pool`` row is timed
   at L_UNCHUNKED through ``sgb.sgb_contract_pool_prepared``, its
   ``sgb_contract_pool_dma`` row at L through
   ``sgb_dma.sgb_contract_pool_dma_prepared``. It is also held at L=800
   over 3 seeds, and bit for bit to its plain version on spike inputs at
   L=240, 800, L_UNCHUNKED and L (``sgb_dma.spike_inputs``: spikes at
   window offsets 0, 1, 78, 79 and at the sequence ends, every f32 sum
   exact, so a tap that reads one row off differs; 3 and 25 windows leave
   a masked last tile). The conv stack is also held bit for bit to
   its plain version at L and L_UNCHUNKED with weights that only shift, to
   either side (exact small integers, so a tile whose halo is a row short
   differs), and prints its tile count and its achieved TFLOP/s on the
   positions it keeps and on the rows it computes (halos included); the
   build prints every ptxas line that names ``wgmma`` (a serialized
   ``wgmma`` runs far below its rate) and the line that names each
   function (the streamed kernel's two instantiations, serving and kernel
   A, share a source).
3. The probe: ``stofnet_tpu_torch.scripts.dma_probe``'s sweep on the
   card, every point held to its total (rtol 1e-3 of the PyTorch sum), to
   each element of the plain version (64 f32 epsilons of the sum of its
   terms' magnitudes) and to the same bits twice; prints its
   ``manual_dma_bandwidth`` line.
4. Serves through ``serve.make_pipeline`` with a seeded random-init
   StofNet (different-armadillo architecture, x4) at two lengths, each
   over one warm-up batch and 4 fresh batches of 128 echo-bearing
   waveforms: at L=8000 and at L_UNCHUNKED=2000 (L % 800 != 0) the
   serving SGB kernel and the conv stack must launch once on every batch,
   and no other kernel; the counts are set to 0 before each length and
   read after it. At each length >= 0.99
   of the coords must lie within 1 sample of the plain path's (the same
   forward through the plain versions). Prints the agreement over coord
   slots and over rows with a detection, ms per batch (median of the 4),
   witnesses of where decoded positions move (the plain path on the CPU,
   the StofNet module in bf16 and in f32), and device time by kernel over
   the 4 batches served again under the profiler. Fails when the kernel
   path moves more rows against the plain path than twice those that the
   plain path moves between the card and the CPU (f32 summation order
   alone), plus 4. Then one batch of 128 at L_MODULE=1000 (L % 80 != 0),
   which the pipeline serves through the ``StofNet`` module (its module
   route): it must launch no kernel and agree with the bf16 module on
   >= 0.99 of the coord slots.
5. Holds the trainable SGB op's kernels against their plain versions at
   B=128, L=8000, F=512: kernel A (forward with argmax, the streamed
   kernel's ``wgmma`` loop on the ``sgb_dma_weights`` image) to the
   tolerance above, its offsets equal to the plain version's wherever the
   plain window maximum beats its runner-up by more than 1e-3 of its
   magnitude, and bit for bit, pooled and offsets, on spike inputs at
   L=800 and L (ties across whole windows); kernel B (backward) per
   output on kernel A's own outputs, its f32 sums (dkernel, dbias) also to
   relative L2 1e-5, and bitwise equal
   over two runs; then bit for bit to its plain version on
   ``sgb.bwd_exact_inputs`` at L=800 and L (every sum exact, offsets at the
   window seams, so a missed seam term differs). Times both as in 2
   (kernel A's yardstick: cuDNN conv + max-pool with indices + leaky;
   kernel B's: the backward of cuDNN conv + max-pool + leaky in bf16, timed
   alone), prints kernel A's device time under the profiler beside its
   bound and yardstick, with the device time of the weight image the op
   builds each step, kernel B's device time by pass and its CUDA-core
   floor beside its bound, and requires one
   forward + backward of the op to stay below the 1.05 GB of one
   (128, 8000, 512) bf16 plane of device memory.
6. The bench's paths (``bench_paths.py``) over a gate batch and 4 fresh
   batches: ``try_fused_pipeline`` (the streamed SGB kernel, the conv stack
   as plain convs) must pass its gate against the plain path on the card
   (``stofnet_apply_reference(fused_stack=False)``),
   launch the streamed kernel on every batch and not the conv-stack
   kernel, agree with the plain path on >= 0.99 of the coord
   slots, and move no more rows against it than twice those the plain path
   moves between the card and the CPU, plus 4; its agreement with the f32
   ``StofNet`` module (the bench's own gate) is printed. Then
   ``try_packed_pipeline`` (plain PyTorch, no kernel) gated on and held to
   >= 0.99 of the bf16 ``StofNet`` module's coord slots. Each path prints
   ms per batch (median of the 4), waveforms/s and device time by kernel
   under the profiler.
7. Trains: ``train.make_fused_train_step`` (bf16 forward, f32 masters,
   AdamW with the cosine schedule) on the same architecture (weights from
   the next seed) at B=128, L=8000 over seeded noise frames with two GT
   echoes per row. First the gradients of one step through the kernels
   against the same step through the plain versions on the card
   (relative L2 per parameter <= 2e-2; the plain path in bf16 against
   f32 printed beside it), then
   one warm-up step and 4 timed steps on 4 other batches: both kernels
   launch on every step, every loss is finite, and the warm-up batch's
   loss is lower after the steps. Prints ms per step (median), training
   waveforms per second, peak memory and device time by kernel over the
   4 batches trained on again under the profiler. Last, a witness: the
   same 5 steps from the serving weights, through the kernels and through
   the plain versions, with the warm-up batch's loss before and after.
From here on the script runs under PyTorch's own TF32 defaults (cuDNN's
   on, cuBLAS's off), as a daemon process serves; each plain reference
   these phases compare with computes in its own TF32-off scope
   (``ops/conv.full_f32``). First what TF32 moves: the daemon gate's batch
   (16 echo rows at L=8000, seed 3008) through the f32 ``StofNet`` module
   and the f32 int8 route with TF32 on and off (the ``tf32 rows`` line:
   rows that differ, rows moved by more than 1 sample); ``make_pipeline``
   in f32 must give the module's TF32-off coords bit for bit and leave the
   caller's flag on.
8. The serving daemon (``cli/serve.build``) from a checkpoint of the
   serving weights written by ``train/checkpoint.save_checkpoint``, at
   L=8000, max_batch 128, max_wait_ms 2, its dtype gate left at auto
   (the gate's agreement and verdict are printed) and every bucket warmed
   before the server binds: 8 client threads send 64 single echo-bearing
   waveforms each and one more client a batch of 128 over the s8c wire.
   Every returned row must equal ``make_pipeline``'s direct coords for it
   bit for bit (the s8c rows: on the decoded wire rows). Prints
   requests/s, p50 and p99 single-request latency, the buckets used, the
   client's stats query and the kernels' launches during the traffic
   (counts set to 0 just before it), each kernel once a batch. The gate
   must serve bf16 on these weights, and the serving SGB kernel and the
   conv stack must both launch. The daemon is shut down and drained.
9. The int8-SGB route of ``make_pipeline``, calibrated on a (128, 1,
   8000) gate batch, the launch counts set to 0 before the phase and held
   at 0 after it: served in bf16 and in f32 over a warm-up batch and 4
   timed batches (ms per batch, peak memory; device time by kernel of the
   bf16 route under the profiler). The bf16 route must equal the same
   forward with the s8 conv as K shifted products on the card bit for
   bit, and move no more rows against its CPU twin (the same bf16 int8
   forward on the CPU on the card's calibration) than twice what
   summation order moves in the bf16 ``StofNet`` module (card against
   CPU) plus 4;
   the f32 route to the f32 module on >= 0.99 of the slots (the bench's
   gate, as the JAX package's int8 test holds it). Then
   ``bench_paths.try_int8_pipeline`` must return a pipe gated against the
   twin on the calibration batch, whose coords equal the served bf16
   route's bit for bit; it prints its s8 conv's form.
10. The export phase: ``serve.export_pipeline`` at B=128, L=8000, bf16 on
   the seeded weights, a batch-polymorphic artifact (``batch="b"``), one
   at the fixed batch 128 and a weightless one (the state from its
   ``.weights.npz`` sidecar), each exported, saved and loaded on the card
   (export and load seconds, file size): on 4 fresh gate batches each must
   launch the serving SGB kernel and the conv stack once a batch through
   their custom ops and give ``make_pipeline``'s direct coords bit for
   bit; ms per batch (median of 4) beside the direct pipeline's, and the
   device time of the weight layouts the weightless program runs on every
   call. Then the daemon from two artifacts (``artifact=``, L=8000 and
   L=2000, both batch-polymorphic) under the daemon phase's traffic, half
   the clients at each length: every row bit for bit ``make_pipeline``'s,
   each kernel once a batch.
11. Prints one ``{"kernels": [...]}`` line (seven kernels, each with the
   launches of its paths: the serving, bench, training, probe, daemon and
   export runs, each counted from 0, summed over the paths that launch
   it; the serving instantiation's launches go to ``sgb_contract_pool`` at
   L_UNCHUNKED and to ``sgb_contract_pool_dma`` at L, on the fused path
   and through the daemons), the card's name and power limit, and as the
   last line ``{"ok": true, "device": {...}}``.

Any failure raises, and the script exits non-zero. It exits non-zero
without a CUDA device too.
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from stofnet_tpu_torch.bench_paths import (
    AGREE_MIN, coord_agreement, make_xla_pipeline, try_fused_pipeline,
    try_int8_pipeline, try_packed_pipeline,
)
from stofnet_tpu_torch.cli import serve as serve_cli
from stofnet_tpu_torch.data.synthetic import gate_batch
from stofnet_tpu_torch.models import (
    StofNet, stofnet_apply_fused, stofnet_apply_reference,
)
from stofnet_tpu_torch.models.int8 import (
    quantize_stofnet, stofnet_apply_int8,
)
from stofnet_tpu_torch.ops.kernels import (
    KERNEL_MODULES, SOURCES, _build, conv_stack, dma_probe,
    reset_launch_counts, sgb, sgb_dma,
)
from stofnet_tpu_torch.ops.kernels._timing import time_ms
from stofnet_tpu_torch.ops.conv import conv1d_same, full_f32
from stofnet_tpu_torch.ops.peaks import mask2coords
from stofnet_tpu_torch.scripts import dma_probe as probe_script
from stofnet_tpu_torch.serve import (
    export_pipeline, export_pipeline_weightless, load_pipeline, make_pipeline,
    module_coords, save_pipeline,
)
from stofnet_tpu_torch.serving import (
    ServingClient, decode_payload, encode_rows,
)
from stofnet_tpu_torch.serving.codecs import DEFAULT_CHUNKS
from stofnet_tpu_torch.serving.tcp import WIRE_INT8C
from stofnet_tpu_torch.train import (
    LossConfig, fused_loss, make_fused_train_step, make_optimizer,
)
from stofnet_tpu_torch.train.checkpoint import save_checkpoint

B, L, UP = 128, 8000, 4
L_UNCHUNKED = 2000  # a serving length JAX's dma_supported refuses (L % 800)
L_MODULE = 1000  # a serving length the fused forward does not take (L % 80)
# the kernels each served batch launches, by length and counter
SERVE = {L: {"sgb_dma.launches": 1, "conv_stack.launches": 1},
         L_UNCHUNKED: {"sgb_dma.launches": 1, "conv_stack.launches": 1}}
# the kernels line's row of the serving SGB kernel's launches, by length
SGB_ROW = {L: "sgb_contract_pool_dma", L_UNCHUNKED: "sgb_contract_pool"}
DECODE = dict(window_size=20, threshold=None, upsample_factor=UP,
              max_echoes=8)
SEED = 0
TOL = 2e-2  # max|kernel - plain| <= TOL * max|plain|: bf16 outputs
N_BATCHES = 4
ROW_NOISE = 4  # rows of counting noise allowed beside the summation witness
PEAK_BF16 = 989e12  # FLOP/s, H100 SXM dense bf16 (data sheet)
PEAK_F32 = 67e12  # FLOP/s, H100 SXM f32 on the CUDA cores (data sheet)
PEAK_HBM = 3.35e12  # B/s, H100 SXM HBM3 (data sheet)
MARGIN = 1e-3  # offsets compared where max - runner-up > MARGIN * |max|
PLANE_BYTES = B * L * 512 * 2  # one (128, 8000, 512) bf16 pre-pool plane
GRAD_TOL = 2e-2  # relative L2 of each gradient leaf, kernels vs plain
SUM_TOL = 1e-5  # relative L2 of kernel B's f32 sums (dkernel, dbias)
OPT = dict(lr=5e-4, weight_decay=1e-8, epochs=80, steps_per_epoch=100)
N_STEPS = 4  # timed training steps, after one warm-up step
DMA_SEEDS = 3  # seeds of the streamed SGB kernel's check at L=800
HOST_CALLS = 1000  # back-to-back calls of the canary's host-time reading
PROFILE_CALLS = 100  # calls of the canary's device-time reading
DAEMON_CLIENTS = 8  # client threads of single-waveform requests
DAEMON_REQUESTS = 64  # single-waveform requests per client
DAEMON_ECHOES = 64  # cli/serve.py's default max_echoes
GATE_ROWS, GATE_SEED = 16, 3008  # the daemon's dtype gate batch (L=8000)


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def bound(nbytes: float, bf16: float = 0.0, f32: float = 0.0):
    """Least time in ms for ``nbytes`` moved and ``bf16`` + ``f32`` FLOP,
    each type at its peak, and which of the two sets it."""
    t_ops = (bf16 / PEAK_BF16 + f32 / PEAK_F32) * 1e3
    t_bytes = nbytes / PEAK_HBM * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def variants(t: torch.Tensor, n: int = 4):
    """``n`` distinct copies of a batch (rolled along the batch axis): a
    launch cycling through them finds its input evicted from the 50 MB L2
    cache by the three others read since (each at least 33 MB at the
    paths' shapes)."""
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


def contract_bf16(state):
    """The contract conv's kernel (5, 64, 512) and bias in bf16."""
    w = state["semi_global_block.contract_conv.weight"].permute(2, 1, 0)
    b = state["semi_global_block.contract_conv.bias"].to(torch.bfloat16)
    return w.to(torch.bfloat16).contiguous(), b


def sgb_yardstick_ms(hs, w, b) -> float:
    """The SGB kernels' yardstick: cuDNN conv + pool + leaky in bf16 on
    channels-first copies of the inputs."""
    wc = w.permute(2, 1, 0).contiguous()
    return time_ms(lambda x: F.leaky_relu(F.max_pool1d(
        F.conv1d(x, wc, b, padding=2), sgb.POOL), 0.01),
        [(x.transpose(1, 2).contiguous(),) for x in hs])


def sgb_bound(h, w, b):
    """The SGB contract+pool's bound: its inputs and pooled output moved
    once, the direct conv's bf16 operations."""
    bsz, length, _ = h.shape
    f = w.shape[2]
    return bound(nbytes(h, w, b) + bsz * (length // sgb.POOL) * f * 2,
                 bf16=2.0 * bsz * length * f * w.shape[0] * w.shape[1])


def kernel_sgb(dev, rng, state) -> dict:
    """JAX's ``sgb_contract_pool`` counterpart (the serving instantiation
    of the streamed kernel) at the shapes the main path gives it: B=128 at
    L_UNCHUNKED, a serving length JAX's DMA kernel refuses; then bit for
    bit on spike inputs at L=240 and L_UNCHUNKED (odd window counts)."""
    h = torch.from_numpy(rng.standard_normal((B, L_UNCHUNKED, 64),
                                             np.float32)).to(
        dev, torch.bfloat16)
    w, b = contract_bf16(state)
    # as make_pipeline lays it out
    image, bias = sgb.sgb_dma_weights(w, b, torch.bfloat16)
    err = check_close("sgb_contract_pool",
                      sgb.sgb_contract_pool_prepared(h, image, bias),
                      sgb.sgb_contract_pool_reference(h, w, b))
    for length in (240, L_UNCHUNKED):
        spike_bits(length, dev, sgb.sgb_contract_pool)

    hs = variants(h)
    ms = time_ms(lambda x: sgb.sgb_contract_pool_prepared(x, image, bias),
                 [(x,) for x in hs])
    plain_ms = time_ms(lambda x: sgb.sgb_contract_pool_reference(x, w, b),
                       [(x,) for x in hs])
    t, by = sgb_bound(h, w, b)
    flop = 2.0 * B * L_UNCHUNKED * w.shape[0] * w.shape[1] * w.shape[2]
    log(f"sgb_contract_pool: {ms:.4f} ms at L={L_UNCHUNKED}, "
        f"{flop / ms / 1e9:.1f} TFLOP/s ({t / ms:.3f} of the bound)")
    return dict(name="sgb_contract_pool", route="cuda",
                source="stofnet_tpu_torch/csrc/sgb_contract_pool_dma.cu",
                replaces="stofnet_tpu/ops/pallas/sgb_kernel.py:189",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=t,
                bound_by=by, library_ms=sgb_yardstick_ms(hs, w, b))


def shift_state(up: int, side: str, dev) -> dict:
    """Conv-stack weights that only shift to one side: every layer's output
    is its input at one outermost tap (identity there, zeros elsewhere,
    zero biases), so output p sums inputs up to 34 rows away along paths
    of weight 1."""
    tap_mid, tap_last = (0, 0) if side == "left" else (6, 2)
    state = {}
    for i in range(2, 13):
        w = torch.zeros(64, 64, 7, device=dev)
        w[:, :, tap_mid] = torch.eye(64, device=dev)
        state[f"conv{i}.weight"] = w
        state[f"conv{i}.bias"] = torch.zeros(64, device=dev)
    w = torch.zeros(up, 64, 3, device=dev)
    w[:, :up, tap_last] = torch.eye(up, device=dev)
    state["conv_last.weight"] = w
    state["conv_last.bias"] = torch.zeros(up, device=dev)
    return state


def kernel_stack(dev, rng, state) -> dict:
    """Fused conv stack at the main path's shapes and types."""
    h0 = torch.from_numpy(rng.standard_normal((B, L, 64), np.float32)).to(
        dev, torch.bfloat16)
    wts = conv_stack.stack_weights(state, torch.bfloat16)  # as make_pipeline
    err = check_close("conv_stack_fused",
                      conv_stack.conv_stack_fused_prepared(h0, wts),
                      conv_stack.conv_stack_fused_reference(h0, state))
    # the halo and seams: with shift weights and inputs in {1, 2, 3} every
    # value is an integer under 256, exact in bf16 and in any order of f32
    # sums, and a path to a row outside a tile's halo is missed exactly
    for length in (L, L_UNCHUNKED):
        x = torch.from_numpy(rng.integers(1, 4, (B, length, 64)).astype(
            np.float32)).to(dev, torch.bfloat16)
        for side in ("left", "right"):
            shift = shift_state(UP, side, dev)
            got = conv_stack.conv_stack_fused(x, shift)
            ref = conv_stack.conv_stack_fused_reference(x, shift)
            torch.cuda.synchronize()
            if not (0 < ref.max().item() < 256 and torch.equal(got, ref)):
                raise AssertionError(
                    f"conv_stack_fused: shift weights ({side}) at L={length}"
                    f": {(got != ref).sum().item()} outputs differ from the "
                    "plain version")
    log(f"conv_stack_fused: shift weights, both sides, L={L} and "
        f"L={L_UNCHUNKED}: the plain version's bits")

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
    useful = 2.0 * B * L * (11 * 7 * 64 * 64 + 3 * 64 * r)
    t, by = bound(nbytes(h0, *weights) + B * L * r * 4, bf16=useful)
    tiles = B * len(conv_stack.tile_plan(L)[0])
    computed = 2.0 * tiles * conv_stack.ROWS * (
        11 * 7 * 64 * 64 + 3 * 64 * conv_stack.MAX_OUT)
    log(f"conv_stack_fused: {tiles} tiles of {conv_stack.ROWS} rows; "
        f"{useful / ms / 1e9:.1f} TFLOP/s on the kept positions, "
        f"{computed / ms / 1e9:.1f} on the computed rows "
        f"({B * L / (tiles * conv_stack.ROWS):.3f} of them kept)")
    return dict(name="conv_stack_fused", route="cuda",
                source="stofnet_tpu_torch/csrc/conv_stack.cu",
                replaces="stofnet_tpu/ops/pallas/conv_stack_kernel.py:137",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=t,
                bound_by=by, library_ms=library_ms)


def canary(dev, rng) -> dict:
    """The canary, right after the build and before any other kernel: 2 x
    must equal x * 2 bit for bit. Its time is the launch's host work."""
    x = torch.from_numpy(rng.standard_normal((8, 128), np.float32)).to(dev)
    got = dma_probe.canary(x)
    torch.cuda.synchronize()
    if not torch.equal(got, x * 2):
        raise AssertionError("canary: the kernel's 2 x differs from x * 2 "
                             "(toolchain or CUDA runtime)")
    log("canary: 2 x equals x * 2 bit for bit")
    xs = [(x + i,) for i in range(4)]
    t, by = bound(2 * nbytes(x))
    row = dict(name="canary", route="cuda",
               source="stofnet_tpu_torch/csrc/dma_probe.cu",
               replaces="scripts/dma_probe.py:145", max_abs_err=0.0,
               ms=time_ms(dma_probe.canary, xs),
               plain_ms=time_ms(dma_probe.canary_reference, xs),
               bound_ms=t, bound_by=by,
               library_ms=time_ms(lambda v: torch.mul(v, 2), xs))
    route = {}
    for name, fn, ms in (("canary", dma_probe.canary, row["ms"]),
                         ("torch.mul", lambda v: torch.mul(v, 2),
                          row["library_ms"])):
        route[name] = dict(event_us=ms * 1e3, host_us=host_us(fn, x),
                           device_us=profile_runs(fn, [x] * PROFILE_CALLS)[
                               "device_busy_ms"] * 1e3)
    log(f"canary launch route (us a call): {json.dumps(route)}")
    return row


def host_us(fn, x) -> float:
    """Host microseconds a call of ``fn(x)`` over HOST_CALLS back-to-back
    calls with no synchronise between them (``time.perf_counter``): the
    launch route's host work, which the card, idle, cannot hide."""
    fn(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn(x)
    us = (time.perf_counter() - t0) * 1e6 / HOST_CALLS
    torch.cuda.synchronize()
    return us


def spike_bits(length: int, dev, op=sgb_dma.sgb_contract_pool_dma) -> None:
    """The serving kernel through ``op`` (either of its wrappers) on
    ``sgb_dma.spike_inputs`` at B=128 must give its plain version's bits:
    every f32 sum is exact there, and a tap that reads one row off (a
    short halo, a misplaced window) moves a spike into another window,
    which random inputs at TOL would hide."""
    h, w, b = (torch.from_numpy(a).to(dev)
               for a in sgb_dma.spike_inputs(B, length, seed=length))
    h = h.to(torch.bfloat16)
    got = op(h, w, b)
    ref = sgb.sgb_contract_pool_reference(h, w, b)
    torch.cuda.synchronize()
    if not (0 < ref.float().max().item() < 32 and torch.equal(got, ref)):
        raise AssertionError(f"{op.__name__}: spike inputs at L={length}: "
                             f"{int((got != ref).sum())} outputs differ from "
                             f"the plain version")
    log(f"{op.__name__}: spike inputs at L={length}: the plain version's "
        f"bits")


def kernel_sgb_dma(dev, rng, state) -> dict:
    """The streamed SGB kernel at the main path's shapes and types, then at
    L=800 (one ring's worth of windows and a little more) over DMA_SEEDS
    seeds, and on spike inputs at L=800 and L."""
    w, b = contract_bf16(state)
    # as fused_forward lays it out
    image, bias = sgb_dma.sgb_dma_weights(w, b, torch.bfloat16)
    for seed in range(DMA_SEEDS):
        h8 = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (B, 800, 64), np.float32)).to(dev, torch.bfloat16)
        check_close(f"sgb_contract_pool_dma L=800 seed {seed}",
                    sgb_dma.sgb_contract_pool_dma_prepared(h8, image, bias),
                    sgb_dma.sgb_contract_pool_dma_reference(h8, w, b))
    for length in (800, L):
        spike_bits(length, dev)
    h = torch.from_numpy(rng.standard_normal((B, L, 64), np.float32)).to(
        dev, torch.bfloat16)
    got = sgb_dma.sgb_contract_pool_dma_prepared(h, image, bias)
    err = check_close("sgb_contract_pool_dma", got,
                      sgb_dma.sgb_contract_pool_dma_reference(h, w, b))

    hs = variants(h)
    ms = time_ms(lambda x: sgb_dma.sgb_contract_pool_dma_prepared(
        x, image, bias), [(x,) for x in hs])
    plain_ms = time_ms(lambda x: sgb_dma.sgb_contract_pool_dma_reference(
        x, w, b), [(x,) for x in hs])
    t, by = sgb_bound(h, w, b)
    flop = 2.0 * B * L * w.shape[0] * w.shape[1] * w.shape[2]
    log(f"sgb_contract_pool_dma: {ms:.4f} ms, {flop / ms / 1e9:.1f} TFLOP/s "
        f"({t / ms:.3f} of the bound)")
    return dict(name="sgb_contract_pool_dma", route="cuda",
                source="stofnet_tpu_torch/csrc/sgb_contract_pool_dma.cu",
                replaces="stofnet_tpu/ops/pallas/sgb_dma_kernel.py:158",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=t,
                bound_by=by, library_ms=sgb_yardstick_ms(hs, w, b))


def probe_path():
    """The probe entry point's logic on the card, every point checked
    (``scripts/dma_probe.run``, strict): its kernels line row from the
    fastest point, and the launches of this run."""
    reset_launch_counts()
    res = probe_script.run(strict=True)
    launches = {"stream_probe": dma_probe.probe_launches,
                "canary": dma_probe.canary_launches}
    print(json.dumps(res["line"]), flush=True)
    best = res["best"]
    log(f"probe: best point {best}, {res['ms'][best]:.4f} ms; launches "
        f"{json.dumps(launches)}")
    x_bytes = probe_script.N_ROWS * dma_probe.WIDTH * 2
    t, by = bound(x_bytes + dma_probe.GROUP * dma_probe.WIDTH * 4,
                  f32=probe_script.N_ROWS * dma_probe.WIDTH)
    row = dict(name="stream_probe", route="cuda",
               source="stofnet_tpu_torch/csrc/dma_probe.cu",
               replaces="scripts/dma_probe.py:37",
               max_abs_err=res["max_abs_err"][best], ms=res["ms"][best],
               plain_ms=res["plain_ms"], bound_ms=t, bound_by=by,
               library_ms=res["library_ms"])
    return row, launches


def row_agreement(a: torch.Tensor, b: torch.Tensor):
    """Over the rows with a detection in either: the fraction whose slots
    all lie within 1 sample, and the count of the others."""
    has = (a != 0).any(1) | (b != 0).any(1)
    ok = (a - b).abs().le(1.0).all(1)
    return float(ok[has].float().mean()), int((has & ~ok).sum())


def counts() -> dict:
    """Every launch counter of the kernel modules, as ``module.counter``."""
    return {f"{mod.__name__.rsplit('.', 1)[1]}.{c}": getattr(mod, c)
            for mod in KERNEL_MODULES for c in mod.COUNTERS}


def serve_timed(name, run, batches, per_batch):
    """``run(x)`` over the batches, each timed on the host clock (numpy
    frame in, coords on the host out); on each batch every launch counter
    must rise by its ``per_batch`` launches (0 where absent). Returns the
    coords and the ms of each batch."""
    coords, batch_ms = [], []
    for x in batches:
        before = counts()
        t0 = time.perf_counter()
        coords.append(run(x))  # the copy to the host waits for the card
        batch_ms.append((time.perf_counter() - t0) * 1e3)
        rose = {k: v - before[k] for k, v in counts().items()}
        wrong = {k: v for k, v in rose.items() if v != per_batch.get(k, 0)}
        if wrong:
            raise AssertionError(f"{name}: launches on one batch {wrong}, "
                                 f"not {per_batch}")
    got = torch.cat(coords)
    if got.shape != (len(batches) * B, DECODE["max_echoes"]) or not bool(
            torch.isfinite(got).all()):
        raise AssertionError(f"{name}: bad coords {tuple(got.shape)}")
    return got, batch_ms


def main_path(dev, state, rng) -> dict:
    """make_pipeline at each length of SERVE over one warm-up batch and
    N_BATCHES fresh gate batches, each batch launching the kernels SERVE
    names for its length and no other, the counts set to 0 just before
    each length and read just after; then, per length, the agreement with
    the plain path, the witnesses and the profile. Returns the launches of
    the served batches by kernels-line row."""
    pipe = make_pipeline(state, {"upsample_factor": UP}, device=dev,
                         window_size=DECODE["window_size"],
                         threshold=DECODE["threshold"],
                         max_echoes=DECODE["max_echoes"])

    def run(x):
        return pipe(x).cpu()

    batches = {}
    for length in SERVE:
        run(gate_batch(B, length, rng))  # cuDNN's algorithm choice, not timed
        batches[length] = [gate_batch(B, length, rng)
                           for _ in range(N_BATCHES)]
    served, launches = {}, {"conv_stack_fused": 0}
    for length, per_batch in SERVE.items():
        reset_launch_counts()
        served[length] = serve_timed(f"main path L={length}", run,
                                     batches[length], per_batch)
        c = counts()
        launches[SGB_ROW[length]] = c["sgb_dma.launches"]
        launches["conv_stack_fused"] += c["conv_stack.launches"]
    log(f"main path launches: {json.dumps(launches)}")
    module_route(dev, state, pipe, run, rng)

    params = {k: v.to(dev) for k, v in state.items()}
    for length, (got, batch_ms) in served.items():
        name = f"main path L={length}"
        with torch.inference_mode():
            plain = torch.cat([mask2coords(stofnet_apply_reference(
                params, torch.from_numpy(x).to(dev)), **DECODE).cpu()
                for x in batches[length]])
        if bool((got < 0).any() or (got > length).any()):
            raise AssertionError(f"{name}: coords outside [0, {length}]")
        agree = coord_agreement(got, plain)
        rows, moved = row_agreement(got, plain)
        ms = float(np.median(batch_ms))
        out = dict(coord_agreement=agree, row_agreement=rows,
                   rows_moved=moved, rows=int(got.shape[0]),
                   detections_per_row=float((got != 0).sum(1).float().mean()),
                   ms_per_batch=ms, batch_ms=batch_ms,
                   waveforms_per_s=B / ms * 1e3)
        log(f"{name}: {json.dumps(out)}")
        if agree < AGREE_MIN:
            raise AssertionError(f"{name}: coord agreement {agree} < "
                                 f"{AGREE_MIN}")
        wit = witness(dev, state, batches[length], got, plain)
        log(f"{name} witness: {json.dumps(wit)}")
        base = wit["plain~plain_cpu"]["moved"]
        if moved > 2 * base + ROW_NOISE:
            raise AssertionError(
                f"{name}: the kernel path moves {moved} rows against the "
                f"plain path, more than twice the {base} that f32 summation "
                f"order alone moves (plain path on the CPU) plus {ROW_NOISE}")
        prof = profile_runs(run, batches[length])
        prof["idle_share_derived"] = 1.0 - prof["device_busy_ms"] / ms
        log(f"{name} profile: {json.dumps(prof)}")
    return launches


def module_route(dev, state, pipe, run, rng) -> None:
    """One batch at L_MODULE through the main pipeline: its module route,
    which launches no kernel (serve_timed holds every counter still) and
    must agree with the bf16 StofNet module on >= AGREE_MIN of the coord
    slots."""
    x = gate_batch(B, L_MODULE, rng)
    before = pipe.calls["module"]
    got, batch_ms = serve_timed(f"main path L={L_MODULE}", run, [x], {})
    ref = torch.from_numpy(module_coords(
        state, {"upsample_factor": UP}, x, torch.bfloat16, dev,
        window_size=DECODE["window_size"], threshold=DECODE["threshold"],
        max_echoes=DECODE["max_echoes"]))
    agree = coord_agreement(got, ref)
    out = dict(route_calls=pipe.calls["module"] - before,
               coord_agreement_module_bf16=agree, ms=batch_ms[0])
    log(f"main path L={L_MODULE}: {json.dumps(out)}")
    if out["route_calls"] != 1 or agree < AGREE_MIN:
        raise AssertionError(f"main path L={L_MODULE}: {out}, not one module "
                             f"call at >= {AGREE_MIN} of the slots")


def bench_paths(dev, state, rng) -> dict:
    """The bench's fused and packed paths over a gate batch (their warm-up)
    and N_BATCHES fresh batches; launch counts of the fused path."""
    ov = {"upsample_factor": UP}
    xg = torch.from_numpy(gate_batch(B, L, rng)).to(dev)
    batches = [gate_batch(B, L, rng) for _ in range(N_BATCHES)]
    cpu_state = {k: v.cpu() for k, v in state.items()}

    def plain(st, x):  # the fused path's plain versions
        return mask2coords(stofnet_apply_reference(
            st, x, fused_stack=False), **DECODE)

    m16 = make_xla_pipeline(ov, torch.bfloat16, dev)
    m32 = make_xla_pipeline(ov, None, dev)
    t0 = time.perf_counter()
    with torch.inference_mode():
        ref_gate = plain(state, xg).cpu()
        ref, ref_cpu, c16, c32 = [], [], [], []
        for x in batches:
            xd = torch.from_numpy(x).to(dev)
            ref.append(plain(state, xd).cpu())
            ref_cpu.append(plain(cpu_state, torch.from_numpy(x)))
            c16.append(m16(state, xd).cpu())
            c32.append(m32(state, xd).cpu())
        c16_gate = m16(state, xg).cpu()
    ref, ref_cpu = torch.cat(ref), torch.cat(ref_cpu)
    c16, c32 = torch.cat(c16), torch.cat(c32)
    log(f"bench paths: references {time.perf_counter() - t0:.1f} s")

    fused = try_fused_pipeline(state, ov, xg, ref_gate)
    if fused is None:
        raise AssertionError("try_fused_pipeline: the gate refused the fused "
                             "path against the plain path")
    reset_launch_counts()
    got, ms, launches = serve_bench_path("fused", fused, dev, state, batches,
                                         {"sgb_dma.launches": 1})
    agree = coord_agreement(got, ref)
    rows, moved = row_agreement(got, ref)
    base = row_agreement(ref, ref_cpu)[1]
    out = dict(coord_agreement=agree, row_agreement=rows, rows_moved=moved,
               plain_rows_moved_card_vs_cpu=base,
               module_f32=dict(slots=coord_agreement(got, c32),
                               moved=row_agreement(got, c32)[1]),
               ms_per_batch=ms, waveforms_per_s=B / ms * 1e3,
               launches={"sgb_contract_pool_dma": launches[
                   "sgb_dma.launches"]})
    log(f"fused path: {json.dumps(out)}")
    if agree < AGREE_MIN:
        raise AssertionError(f"fused path: coord agreement {agree} < "
                             f"{AGREE_MIN}")
    if moved > 2 * base + ROW_NOISE:
        raise AssertionError(
            f"fused path: moves {moved} rows against the plain path, more "
            f"than twice the {base} that f32 summation order alone moves "
            f"(plain path on the CPU) plus {ROW_NOISE}")

    packed = try_packed_pipeline(state, ov, xg, c16_gate)
    if packed is None:
        raise AssertionError("try_packed_pipeline: the gate refused the "
                             "packed path against the bf16 module")
    got, ms, _ = serve_bench_path("packed", packed, dev, state, batches, {})
    agree = coord_agreement(got, c16)
    out_p = dict(coord_agreement_module_bf16=agree,
                 rows_moved_module_bf16=row_agreement(got, c16)[1],
                 module_f32=dict(slots=coord_agreement(got, c32),
                                 moved=row_agreement(got, c32)[1]),
                 ms_per_batch=ms, waveforms_per_s=B / ms * 1e3)
    log(f"packed path: {json.dumps(out_p)}")
    if agree < AGREE_MIN:
        raise AssertionError(f"packed path: coord agreement {agree} with the "
                             f"bf16 module < {AGREE_MIN}")
    return out


def serve_bench_path(name, pipe, dev, state, batches, per_batch):
    """``pipe(state, x)`` over the batches as :func:`serve_timed` serves
    them. Returns (coords, median ms, the launch counters after the
    batches); then device time by kernel under the profiler."""
    def run(x):
        return pipe(state, torch.from_numpy(x).to(dev)).cpu()

    got, batch_ms = serve_timed(f"{name} path", run, batches, per_batch)
    launches = counts()
    ms = float(np.median(batch_ms))
    prof = profile_runs(run, batches)
    prof["idle_share_derived"] = 1.0 - prof["device_busy_ms"] / ms
    log(f"{name} path profile: {json.dumps(prof)}")
    return got, ms, launches


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
        out[name] = dict(rows=rows, moved=moved, slots=coord_agreement(a, b))
    out["seconds"] = time.perf_counter() - t0
    return out


def profile_runs(run_one, items) -> dict:
    """Device time by kernel over ``run_one(x)`` for each of ``items``
    (each run ends in a copy to the host), under the profiler: where a
    batch's or a step's time goes. Its wall time is the profiler's, so the
    idle share is derived against the unprofiled median."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for x in items:
            run_one(x)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / len(items)
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict = {}
    for e in kern:  # names cut to 60 characters; sum what they merge
        name = e.key[:60]
        by_name[name] = (by_name.get(name, 0.0)
                         + e.self_device_time_total / len(items))
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(runs=len(items), profiled_wall_ms=wall_us / 1e3,
                device_busy_ms=busy_us / 1e3,
                top_ms={k: v / 1e3 for k, v in top})


def kernels_trainable(dev, rng, state):
    """Kernels A and B of the trainable SGB op at the main path's shapes:
    the f32 master weights of the contract conv, bf16 features."""
    h = torch.from_numpy(rng.standard_normal((B, L, 64), np.float32)).to(
        dev, torch.bfloat16)
    w = state["semi_global_block.contract_conv.weight"].permute(
        2, 1, 0).contiguous()  # (5, 64, 512) f32
    b = state["semi_global_block.contract_conv.bias"]
    f = w.shape[2]
    image, bias = sgb.sgb_dma_weights(w, b, torch.bfloat16)  # as the op does
    pooled, off = sgb.sgb_contract_pool_argmax(h, image, bias)
    ref_pooled, ref_off = sgb.sgb_contract_pool_argmax_reference(h, w, b)
    err_a = check_close("sgb_contract_pool_argmax", pooled, ref_pooled)
    y = conv1d_same(h.float(), w.to(h.dtype).float(), b.to(h.dtype).float())
    top = y.reshape(B, L // sgb.POOL, sgb.POOL, f).topk(2, dim=2).values
    del y
    clear = (top[:, :, 0] - top[:, :, 1]) > MARGIN * top[:, :, 0].abs()
    differ = off != ref_off
    offsets = dict(mismatch_rate=float(differ.float().mean()),
                   clear_share=float(clear.float().mean()),
                   mismatch_clear=int((differ & clear).sum()))
    log(f"sgb_contract_pool_argmax offsets: {json.dumps(offsets)}")
    if offsets["mismatch_clear"]:
        raise AssertionError("kernel A's offsets differ from the plain "
                             "version's where the window maximum is clear")
    for length in (800, L):
        argmax_spike_bits(length, dev)

    g = torch.from_numpy(rng.standard_normal(pooled.shape, np.float32)).to(
        dev, torch.bfloat16)
    got = sgb.sgb_contract_pool_bwd(h, w, g, pooled, off)
    again = sgb.sgb_contract_pool_bwd(h, w, g, pooled, off)
    ref = sgb.sgb_contract_pool_bwd_reference(h, w, g, pooled, off)
    err_b = 0.0
    for name, x, y2, z in zip(("dh", "dkernel", "dbias"), got, again, ref):
        err_b = max(err_b, check_close(f"sgb_contract_pool_bwd {name}", x, z))
        if not torch.equal(x, y2):
            raise AssertionError(f"sgb_contract_pool_bwd {name}: two runs on "
                                 "the same inputs differ")
        if name != "dh":  # f32 sums of exact products: order alone differs
            rel = rel_l2(x, z)
            log(f"sgb_contract_pool_bwd {name}: relative L2 {rel:.3g}")
            if not rel <= SUM_TOL:
                raise AssertionError(f"sgb_contract_pool_bwd {name}: relative "
                                     f"L2 {rel} > {SUM_TOL}")
    log("sgb_contract_pool_bwd: two runs bitwise equal")
    for length in (800, L):
        bwd_exact_bits(length, dev)
    peak = trainable_peak_bytes(h, w, b, g)
    log(f"trainable op forward + backward: peak {peak / 1e6:.1f} MB above "
        f"the inputs (one bf16 pre-pool plane: {PLANE_BYTES / 1e6:.1f} MB)")
    if peak >= PLANE_BYTES:
        raise AssertionError(f"the trainable op took {peak} bytes, not less "
                             f"than one (B, L, 512) bf16 plane")

    hs = variants(h)
    fwd = [sgb.sgb_contract_pool_argmax(x, image, bias) for x in hs]
    gs = variants(g)
    ms_a = time_ms(lambda x: sgb.sgb_contract_pool_argmax(x, image, bias),
                   [(x,) for x in hs])
    # 20 calls: over 4, one reading came to 3/4 of the event time (an
    # event lost to the profiler), which 20 calls dilute
    device_a = profile_runs(lambda x: sgb.sgb_contract_pool_argmax(
        x, image, bias), hs * 5)
    layout = profile_runs(lambda _: sgb.sgb_dma_weights(
        w, b, torch.bfloat16), [None] * 20)
    plain_a = time_ms(
        lambda x: sgb.sgb_contract_pool_argmax_reference(x, w, b),
        [(x,) for x in hs])
    # yardstick: cuDNN conv + pool with indices + leaky, bf16, channels-first
    hc = [(x.transpose(1, 2).contiguous(),) for x in hs]
    wc, bc = w.permute(2, 1, 0).to(torch.bfloat16), b.to(torch.bfloat16)

    def library_a(x):
        y, idx = F.max_pool1d(F.conv1d(x, wc, bc, padding=2), sgb.POOL,
                              return_indices=True)
        return F.leaky_relu(y, 0.01), idx
    lib_a = time_ms(library_a, hc)
    t_a, by_a = bound(nbytes(h, image, bias, pooled, off),
                      bf16=2.0 * B * L * f * w.shape[0] * w.shape[1])
    log(f"sgb_contract_pool_argmax: {ms_a:.4f} ms (device "
        f"{device_a['device_busy_ms']:.4f} ms a call under the profiler, "
        f"{json.dumps(device_a['top_ms'])}), bound {t_a:.4f} ms by {by_a}, "
        f"library (cuDNN conv + pool with indices + leaky) {lib_a:.4f} ms; "
        f"the weight image it takes, built each step: device "
        f"{layout['device_busy_ms']:.4f} ms a call "
        f"{json.dumps(layout['top_ms'])}")

    bwd_args = [(x, gi, p, o) for x, gi, (p, o) in zip(hs, gs, fwd)]
    ms_b = time_ms(lambda x, gi, p, o: sgb.sgb_contract_pool_bwd(
        x, w, gi, p, o), bwd_args)
    plain_b = time_ms(lambda x, gi, p, o: sgb.sgb_contract_pool_bwd_reference(
        x, w, gi, p, o), bwd_args)
    split = profile_runs(lambda a: sgb.sgb_contract_pool_bwd(
        a[0], w, *a[1:]), bwd_args)
    log(f"sgb_contract_pool_bwd passes, device ms a call: "
        f"{json.dumps(split['top_ms'])}")
    # yardstick: the backward alone of cuDNN conv + max-pool + leaky in bf16
    graphs = []
    for x, gi in zip(hs[:2], gs[:2]):
        xc = x.transpose(1, 2).contiguous().requires_grad_(True)
        wl = wc.detach().clone().requires_grad_(True)
        bl = bc.detach().clone().requires_grad_(True)
        out = F.leaky_relu(F.max_pool1d(F.conv1d(xc, wl, bl, padding=2),
                                        sgb.POOL), 0.01)
        graphs.append((out, (xc, wl, bl), gi.transpose(1, 2).contiguous()))
    lib_b = time_ms(lambda out, inputs, gc: torch.autograd.grad(
        out, inputs, gc, retain_graph=True), graphs)
    del graphs
    # work this run's offsets need: taps that land inside [0, L)
    pos = (off.long() - sgb.PAD
           + torch.arange(L // sgb.POOL, device=dev)[:, None] * sgb.POOL)
    taps = sum(int(((pos + t >= 0) & (pos + t < L)).sum())
               for t in range(sgb.KSIZE))
    # dkernel: bf16 x bf16 products summed in f32, the bf16 tensor-core
    # type; dh: f32 g_pre x f32 w, and dbias, on the f32 CUDA cores
    t_b, by_b = bound(nbytes(h, w, g, pooled, off, *got),
                      bf16=2.0 * taps * 64,
                      f32=2.0 * taps * 64 + 2.0 * pooled.numel())
    # the kernel's own design runs both passes' products in f32 on the
    # CUDA cores: its floor, beside the bound
    floor_b = (4.0 * taps * 64 + 2.0 * pooled.numel()) / PEAK_F32 * 1e3
    log(f"sgb_contract_pool_bwd: {ms_b:.4f} ms; bound {t_b:.4f} ms by "
        f"{by_b}, CUDA-core floor of the design {floor_b:.4f} ms")
    a = dict(name="sgb_contract_pool_argmax", route="cuda",
             source="stofnet_tpu_torch/csrc/sgb_contract_pool_dma.cu",
             replaces="stofnet_tpu/ops/pallas/sgb_kernel.py:209",
             max_abs_err=err_a, ms=ms_a, plain_ms=plain_a, bound_ms=t_a,
             bound_by=by_a, library_ms=lib_a)
    bk = dict(name="sgb_contract_pool_bwd", route="cuda",
              source="stofnet_tpu_torch/csrc/sgb_contract_pool_bwd.cu",
              replaces="stofnet_tpu/ops/pallas/sgb_kernel.py:244",
              max_abs_err=err_b, ms=ms_b, plain_ms=plain_b, bound_ms=t_b,
              bound_by=by_b, library_ms=lib_b)
    return a, bk


def argmax_spike_bits(length: int, dev) -> None:
    """Kernel A on ``sgb_dma.spike_inputs`` at B=128 must give its plain
    version's bits, pooled and offsets: every f32 sum is exact there, the
    all-bias columns tie across whole windows (the first position wins),
    and a tap that reads one row off moves a spike into another window."""
    h, w, b = (torch.from_numpy(a).to(dev)
               for a in sgb_dma.spike_inputs(B, length, seed=length))
    h = h.to(torch.bfloat16)
    image, bias = sgb.sgb_dma_weights(w, b, torch.bfloat16)
    pooled, off = sgb.sgb_contract_pool_argmax(h, image, bias)
    ref_pooled, ref_off = sgb.sgb_contract_pool_argmax_reference(h, w, b)
    torch.cuda.synchronize()
    for name, x, z in (("pooled", pooled, ref_pooled), ("offsets", off,
                                                         ref_off)):
        if not (0 < ref_pooled.float().max().item() < 32
                and torch.equal(x, z)):
            raise AssertionError(f"sgb_contract_pool_argmax {name}: spike "
                                 f"inputs at L={length}: "
                                 f"{int((x != z).sum())} outputs differ from "
                                 f"the plain version")
    log(f"sgb_contract_pool_argmax: spike inputs at L={length}: the plain "
        f"version's bits, pooled and offsets")


def bwd_exact_bits(length: int, dev) -> None:
    """Kernel B on ``sgb.bwd_exact_inputs`` at B=128 must give its plain
    version's bits: every f32 sum is exact there and dh exact in bf16, and
    offsets at window positions 0, 1, 78, 79 put terms across the seams,
    so a missed seam term changes dh where random inputs at TOL hide it."""
    h, w, g, pooled, off = (torch.from_numpy(a).to(dev)
                            for a in sgb.bwd_exact_inputs(B, length,
                                                          seed=length))
    h, g, pooled = (t.to(torch.bfloat16) for t in (h, g, pooled))
    got = sgb.sgb_contract_pool_bwd(h, w, g, pooled, off)
    ref = sgb.sgb_contract_pool_bwd_reference(h, w, g, pooled, off)
    torch.cuda.synchronize()
    for name, x, z in zip(("dh", "dkernel", "dbias"), got, ref):
        if not (z.abs().max().item() > 0 and torch.equal(x, z)):
            raise AssertionError(f"sgb_contract_pool_bwd {name}: exact inputs "
                                 f"at L={length}: {int((x != z).sum())} "
                                 f"outputs differ from the plain version")
    log(f"sgb_contract_pool_bwd: exact inputs at L={length}: the plain "
        f"version's bits")


def trainable_peak_bytes(h, w, b, g) -> int:
    """Peak device memory of one forward + backward of the trainable op,
    above what was allocated before it (its inputs)."""
    hg, wg, bg = (t.detach().clone().requires_grad_(True) for t in (h, w, b))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    sgb.sgb_contract_pool_trainable(hg, wg, bg).backward(g)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def train_batches(rng, n: int, dev):
    """``n`` seeded noise frames (B, 1, L), max-normalized per waveform, and
    the GT of two echoes per row at samples 2000.25 and 5500.5, in
    upsampled units (B, 1, 2): the training bench's recipe."""
    frames = []
    for _ in range(n):
        x = rng.standard_normal((B, 1, L)).astype(np.float32)
        x /= np.abs(x).max(axis=-1, keepdims=True)
        frames.append(torch.from_numpy(x).to(dev))
    gt = np.round(np.array([2000.25, 5500.5]) * UP).astype(np.int32)
    return frames, torch.from_numpy(np.tile(gt, (B, 1, 1))).to(dev)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def trainer(dev, seed: int, cfg, forward=stofnet_apply_fused):
    """StofNet's f32 masters drawn from ``seed`` and the fused train step
    over them with ``forward``: (params, step)."""
    model = StofNet(generator=torch.Generator().manual_seed(seed),
                    device=dev)
    params = dict(model.named_parameters())
    opt, sched = make_optimizer(params.values(), **OPT)
    return params, make_fused_train_step(params, opt, sched, cfg,
                                         forward=forward)


def train_path(dev) -> dict:
    """The fused train step: a gradient witness, one warm-up step, then the
    timed steps with their launch counts, then the seed witness. The
    weights are drawn from seed SEED + 1 (see :func:`seed_witness`)."""
    cfg = LossConfig(upsample_factor=UP, max_echoes=8)
    params, step = trainer(dev, SEED + 1, cfg)
    frames, gt = train_batches(np.random.default_rng(SEED + 1),
                               1 + N_STEPS, dev)

    t0 = time.perf_counter()
    grads = {}
    for name, forward, dt in (
            ("kernel", stofnet_apply_fused, torch.bfloat16),
            ("plain", stofnet_apply_reference, torch.bfloat16),
            ("plain_f32", stofnet_apply_reference, None)):
        loss = fused_loss(params, frames[0], gt, cfg, dt, forward)
        grads[name] = torch.autograd.grad(loss, list(params.values()))
    kernel_vs_plain = {k: rel_l2(a, b) for k, a, b in zip(
        params, grads["kernel"], grads["plain"])}
    bf16_vs_f32 = {k: rel_l2(a, b) for k, a, b in zip(
        params, grads["plain"], grads["plain_f32"])}
    del grads
    log(f"gradients, relative L2 per leaf, kernel path vs plain path: "
        f"{json.dumps(kernel_vs_plain)}")
    log(f"gradients, relative L2 per leaf, plain bf16 vs plain f32: "
        f"{json.dumps(bf16_vs_f32)}")
    log(f"gradient witness: {time.perf_counter() - t0:.1f} s")
    bad = {k: v for k, v in kernel_vs_plain.items() if not v <= GRAD_TOL}
    if bad:
        raise AssertionError(f"gradients beyond relative L2 {GRAD_TOL} of "
                             f"the plain path's (or not finite): {bad}")

    loss0 = float(step(frames[0], gt))  # cuDNN's algorithm choice, not timed
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    for x in frames[1:1 + N_STEPS]:
        before = (sgb.argmax_launches, sgb.bwd_launches)
        t0 = time.perf_counter()
        losses.append(float(step(x, gt)))  # the copy waits for the card
        step_ms.append((time.perf_counter() - t0) * 1e3)
        after = (sgb.argmax_launches, sgb.bwd_launches)
        if not all(a > b for a, b in zip(after, before)):
            raise AssertionError(f"a trainable kernel did not launch on this "
                                 f"step: (A, B) {before} -> {after}")
    launches = {"sgb_contract_pool_argmax": sgb.argmax_launches,
                "sgb_contract_pool_bwd": sgb.bwd_launches}
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        loss_after = float(fused_loss(params, frames[0], gt, cfg))
    ms = float(np.median(step_ms))
    out = dict(loss_warmup=loss0, losses=losses, loss_warmup_after=loss_after,
               ms_per_step=ms, step_ms=step_ms,
               train_waveforms_per_s=B / ms * 1e3, peak_memory_gb=peak / 1e9,
               launches=launches)
    log(f"train path: {json.dumps(out)}")
    if not all(np.isfinite(losses + [loss0, loss_after])):
        raise AssertionError(f"a loss is not finite: {out}")
    if not loss_after < loss0:
        raise AssertionError(f"the warm-up batch's loss did not fall: "
                             f"{loss0} -> {loss_after}")
    prof = profile_runs(lambda x: float(step(x, gt)), frames[1:])
    prof["idle_share_derived"] = 1.0 - prof["device_busy_ms"] / ms
    log(f"train profile: {json.dumps(prof)}")
    log(f"seed witness: {json.dumps(seed_witness(dev, cfg, frames, gt))}")
    return out


def seed_witness(dev, cfg, frames, gt) -> dict:
    """The same 5 steps from the serving weights (seed SEED), through the
    kernels and through their plain versions: each step's loss, and the
    warm-up batch's loss after the steps. These weights start within
    about 0.011 of the loss of an all-zero heatmap, and AdamW's first step
    moves every weight by lr; where both paths end above their start, the
    step itself raises the loss, not the kernels, and the train path's
    weights come from the next seed for that reason. Printed, not held."""
    out = {}
    for name, forward in (("kernel", stofnet_apply_fused),
                          ("plain", stofnet_apply_reference)):
        params, step = trainer(dev, SEED, cfg, forward)
        losses = [float(step(x, gt)) for x in frames]
        with torch.no_grad():
            after = float(fused_loss(params, frames[0], gt, cfg,
                                     forward=forward))
        out[name] = dict(losses=losses, loss_warmup_after=after)
    return out


def daemon_path(dev, state) -> dict:
    """The serving daemon (``cli/serve.build``) from a checkpoint of the
    seeded weights, its dtype gate left at auto, every bucket warmed
    before the server binds, under :func:`daemon_traffic`. On these
    weights the gate serves bf16, whose fused route runs the kernels: the
    phase fails where it chose f32 (the ``StofNet`` module, no kernel) or
    where a kernel of the fused route did not launch. Returns the launches
    of the traffic by kernels-line row."""
    rng = np.random.default_rng(SEED + 3)
    rows = list(gate_batch(DAEMON_CLIENTS * DAEMON_REQUESTS, L, rng)[:, 0])
    batch = gate_batch(B, L, rng)[:, 0]
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(Path(tmp) / "armadillo-seed0.pt", state)
        args = {"model_file": "armadillo", "ckpt_dir": tmp, "length": L,
                "max_batch": B, "max_wait_ms": 2, "port": 0}
        dtype, launches = daemon_traffic("daemon (dtype=auto)", args, state,
                                         dev, rows, batch)
    if dtype != torch.bfloat16 or not all(launches.values()):
        raise AssertionError(f"daemon: served {dtype}, not bf16 on the fused "
                             f"route, or a kernel did not launch: {launches}")
    return launches


def daemon_traffic(name, args, state, dev, rows, batch, dtype=None):
    """Build the daemon of ``args``; DAEMON_CLIENTS clients send
    DAEMON_REQUESTS single waveforms each from the list ``rows`` (client c
    the c-th run of them; their lengths are those the daemon serves) and
    one more client the (B, L) ``batch`` over the s8c wire, the launch
    counts set to 0 just before the traffic and read just after; every
    returned row must equal ``make_pipeline``'s direct coords for it bit
    for bit (the s8c rows: on the decoded wire rows), in ``dtype`` or, when
    None, the one the daemon's dtype gate chose. The route is read from the
    launch counts: on the fused route every batch launches both kernels
    once. Shuts the daemon down and drains it. Returns the daemon's dtype
    and the traffic's launches by kernels-line row, the serving SGB
    kernel's by the length of their batches."""
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        hostd, server, port = serve_cli.build(args)
    build_s = time.perf_counter() - t0
    for line in err.getvalue().splitlines():
        log(f"{name} build: {line}")
    if dtype is None:
        dtype = (torch.bfloat16 if args.get("dtype") == "bfloat16"
                 or "bf16 OK" in err.getvalue() else torch.float32)
    got = [None] * len(rows)
    lat = np.zeros(len(rows))
    box = {}

    def single(c: int) -> None:
        with ServingClient(("127.0.0.1", port)) as cli:
            for i in range(c * DAEMON_REQUESTS, (c + 1) * DAEMON_REQUESTS):
                t = time.perf_counter()
                got[i] = cli.infer(rows[i])
                lat[i] = time.perf_counter() - t

    def wire() -> None:
        with ServingClient(("127.0.0.1", port), wire="s8c") as cli:
            box["s8c"] = cli.infer(batch)
            box["stats"] = cli.stats()

    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=single, args=(c,))
                   for c in range(DAEMON_CLIENTS)]
        threads.append(threading.Thread(target=wire))
        for t in threads:
            t.start()
        for t in threads:
            t.join(300.0)
        wall = time.perf_counter() - t0
        c = counts()
        if any(t.is_alive() for t in threads) or "stats" not in box:
            raise AssertionError(f"{name}: a client did not finish")
    finally:
        server.shutdown()
        server.server_close()
        hostd.close()
    stats = hostd.stats()
    per_length = (stats["per_length"] if "per_length" in stats
                  else {hostd.length: stats})
    batches = {n: s["batches"] for n, s in per_length.items()}
    fused = c["sgb_dma.launches"] > 0
    if (c["sgb_dma.launches"] != c["conv_stack.launches"]
            or (fused and c["sgb_dma.launches"] != sum(batches.values()))):
        raise AssertionError(f"{name}: launches {c} on {batches} batches, "
                             f"not both kernels once a batch")
    launches = {"conv_stack_fused": c["conv_stack.launches"]}
    for n, k in batches.items():
        launches[SGB_ROW[n]] = k if fused else 0

    direct = make_pipeline(state, {"upsample_factor": UP}, dtype=dtype,
                           device=dev)
    want = [None] * len(rows)
    for n in batches:
        idx = [i for i, r in enumerate(rows) if len(r) == n]
        xs = np.stack([rows[i] for i in idx])[:, None]
        coords = np.concatenate([direct(xs[j:j + B]).cpu().numpy()
                                 for j in range(0, len(idx), B)])
        for i, row in zip(idx, coords):
            want[i] = row
    wire_rows = decode_payload(encode_rows(batch, WIRE_INT8C, DEFAULT_CHUNKS),
                               WIRE_INT8C, B, L, DEFAULT_CHUNKS)
    want_s8c = direct(wire_rows).cpu().numpy()
    out = dict(build_s=build_s, dtype=str(dtype),
               route="fused" if fused else "module", route_calls=direct.calls,
               requests=len(rows) + 1, waveforms=len(rows) + B, wall_s=wall,
               requests_per_s=(len(rows) + 1) / wall,
               waveforms_per_s=(len(rows) + B) / wall,
               single_latency_p50_ms=float(np.percentile(lat, 50) * 1e3),
               single_latency_p99_ms=float(np.percentile(lat, 99) * 1e3),
               buckets_used={n: {k: v for k, v in s["bucket_counts"].items()
                                 if v} for n, s in per_length.items()},
               rows_differing=sum(not np.array_equal(g, w)
                                  for g, w in zip(got, want)),
               rows_differing_by_length={n: sum(
                   not np.array_equal(g, w) for g, w, r in
                   zip(got, want, rows) if len(r) == n) for n in batches},
               s8c_rows_differing=int((box["s8c"] != want_s8c).any(1).sum()),
               launches=launches, client_stats=box["stats"])
    log(f"{name}: {json.dumps(out)}")
    if out["rows_differing"] or out["s8c_rows_differing"]:
        raise AssertionError(f"{name}: rows differ from make_pipeline's "
                             f"direct coords: {out['rows_differing']} single"
                             f", {out['s8c_rows_differing']} s8c")
    if stats["errors"] or stats["pending"]:
        raise AssertionError(f"{name}: errors or undrained work: {stats}")
    return dtype, launches


def tf32_rows(dev, state) -> None:
    """What TF32 moves, measured before its repair was trusted: the daemon
    gate's batch (GATE_ROWS echo rows at L, seed GATE_SEED) through the f32
    ``StofNet`` module and the f32 int8 route (calibrated on the int8
    phase's batch), each with cuDNN's TF32 on (PyTorch's default) and off;
    prints the rows whose coords differ, those that move by more than 1
    sample, and the largest change of the heatmap beside its largest
    value. Then the repair: ``make_pipeline`` in f32 under PyTorch's
    default flags must give the module's TF32-off coords bit for bit, and
    leave the flag on."""
    x = gate_batch(GATE_ROWS, L, np.random.default_rng(GATE_SEED))
    ov = {"upsample_factor": UP}
    decode = dict(window_size=DECODE["window_size"],
                  threshold=DECODE["threshold"], max_echoes=DAEMON_ECHOES)
    q = quantize_stofnet(state, gate_batch(B, L, np.random.default_rng(
        SEED + 4)))
    model = StofNet(device=dev)
    model.load_state_dict(state)
    xd = torch.from_numpy(x).to(dev)
    forwards = {"module_f32": model,
                "int8_f32": lambda xb: stofnet_apply_int8(
                    q, xb, dtype=torch.float32)}
    out, off = {}, {}
    for name, forward in forwards.items():
        heat, coords = {}, {}
        for tf32 in (True, False):
            with torch.inference_mode(), (contextlib.nullcontext() if tf32
                                          else full_f32()):
                heat[tf32] = forward(xd)
                coords[tf32] = mask2coords(
                    heat[tf32], DECODE["window_size"], DECODE["threshold"],
                    UP, DAEMON_ECHOES).cpu()
        on, off[name] = coords[True], coords[False]
        out[name] = dict(
            rows=GATE_ROWS, rows_differing=int((on != off[name]).any(1).sum()),
            rows_moved=row_agreement(on, off[name])[1],
            heat_max_abs_diff=float((heat[True] - heat[False]).abs().max()),
            heat_max_abs=float(heat[False].abs().max()))
    pipe = make_pipeline(state, ov, dtype=torch.float32, device=dev, **decode)
    out["pipeline_f32_equals_module_without_tf32"] = bool(torch.equal(
        pipe(x).cpu(), off["module_f32"]))
    out["cudnn_allow_tf32_after"] = torch.backends.cudnn.allow_tf32
    log(f"tf32 rows: {json.dumps(out)}")
    if not (out["pipeline_f32_equals_module_without_tf32"]
            and out["cudnn_allow_tf32_after"]):
        raise AssertionError(f"tf32: the f32 pipeline computes in TF32 or "
                             f"changes the caller's flag: {out}")


def int8_path(dev, state) -> None:
    """The int8-SGB route of ``make_pipeline``, calibrated on a (B, 1, L)
    gate batch, the launch counts set to 0 just before the phase and held
    at 0 just after (no kernel of the port launches: its s8 product is
    ``torch._int_mm``):

    - served in bf16 (its default) and in f32, each over one warm-up
      batch and N_BATCHES fresh batches: ms per batch, peak memory;
    - the bf16 route held to two twins, as the main path holds the
      kernels to the plain path and its CPU witness: bit for bit to the
      same forward on the card with the s8 conv as K shifted products
      (``impl="dots"``; s32 sums are exact, so the codes are the same),
      and to the same bf16 int8 forward on the CPU on the card's
      calibration (the same codes and scales, another order of float
      sums) on moved rows: no more than twice what summation order alone
      moves in a bf16 forward (the bf16 ``StofNet`` module on the card
      against it on the CPU) plus ROW_NOISE. Its slots against the CPU
      twin are printed: bf16 summation order moves more than 1 % of them
      on these weights, in the module as in the int8 route;
    - the f32 route held to the f32 module on >= AGREE_MIN of the slots,
      the bench's gate, as the JAX package's own int8 test holds it: what
      the quantization alone moves (the bf16 route's agreement with the
      f32 and bf16 modules printed beside it; bf16 alone moves more on
      these weights);
    - ``bench_paths.try_int8_pipeline`` on the calibration batch, gated
      against the twin's coords on it: it must return a pipe, which must
      equal the served bf16 route's coords there bit for bit."""
    rng = np.random.default_rng(SEED + 4)
    ov = {"upsample_factor": UP}
    calib = gate_batch(B, L, rng)
    batches = [gate_batch(B, L, rng) for _ in range(N_BATCHES)]
    decode = dict(window_size=DECODE["window_size"],
                  threshold=DECODE["threshold"],
                  max_echoes=DECODE["max_echoes"])
    reset_launch_counts()
    out, got = {}, {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        t0 = time.perf_counter()
        pipe = make_pipeline(state, ov, device=dev, int8_calib=calib,
                             dtype=dtype, **decode)
        calib_s = time.perf_counter() - t0

        def run(x, pipe=pipe):
            return pipe(x).cpu()

        run(gate_batch(B, L, rng))  # cuDNN's algorithm choice, not timed
        torch.cuda.reset_peak_memory_stats()
        got[name], batch_ms = serve_timed(f"int8 route {name}", run,
                                          batches, {})
        peak = torch.cuda.max_memory_allocated()
        ms = float(np.median(batch_ms))
        if pipe.calls["int8"] != 1 + N_BATCHES:
            raise AssertionError(f"int8 route {name}: calls {pipe.calls}")
        out[name] = dict(calibration_s=calib_s, ms_per_batch=ms,
                         batch_ms=batch_ms, waveforms_per_s=B / ms * 1e3,
                         peak_memory_gb=peak / 1e9)
        if name == "bf16":
            served = pipe
            prof = profile_runs(run, batches)
            prof["idle_share_derived"] = 1.0 - prof["device_busy_ms"] / ms
            log(f"int8 route bf16 profile: {json.dumps(prof)}")

    t0 = time.perf_counter()
    q = quantize_stofnet(state, calib)  # the card's calibration
    q_cpu = to_cpu(q)
    with torch.inference_mode(), full_f32():  # the references without TF32
        dots = torch.cat([mask2coords(stofnet_apply_int8(
            q, torch.from_numpy(x).to(dev), impl="dots"), **DECODE).cpu()
            for x in batches])
        twin = [mask2coords(stofnet_apply_int8(
            q_cpu, torch.from_numpy(x)), **DECODE) for x in [calib] + batches]
        ref = {(dt, where): torch.from_numpy(np.concatenate([module_coords(
            state, ov, x, dt, where, **decode) for x in batches]))
            for dt, where in ((torch.float32, dev), (torch.bfloat16, dev),
                              (torch.bfloat16, "cpu"))}
    twin_calib, twin = twin[0], torch.cat(twin[1:])
    m16, m16_cpu, m32 = (ref[torch.bfloat16, dev], ref[torch.bfloat16, "cpu"],
                         ref[torch.float32, dev])

    def pair(a, b):
        return dict(slots=coord_agreement(a, b), moved=row_agreement(a, b)[1])

    out.update(references_s=time.perf_counter() - t0,
               bf16_dots_equal=bool(torch.equal(got["bf16"], dots)),
               bf16_twin=pair(got["bf16"], twin),
               module_bf16_card_cpu=pair(m16, m16_cpu),
               bf16_module_f32=pair(got["bf16"], m32),
               bf16_module_bf16=pair(got["bf16"], m16),
               f32_module_f32=pair(got["f32"], m32))
    log(f"int8 route: {json.dumps(out)}")
    if not out["bf16_dots_equal"]:
        raise AssertionError("int8 route bf16: its coords differ from the "
                             "same forward's with the s8 conv as K shifted "
                             "products on the card (exact s32 sums)")
    moved, base = out["bf16_twin"]["moved"], out["module_bf16_card_cpu"][
        "moved"]
    if moved > 2 * base + ROW_NOISE:
        raise AssertionError(
            f"int8 route bf16: moves {moved} rows against its CPU twin, more "
            f"than twice the {base} that summation order moves in the bf16 "
            f"module (card against CPU) plus {ROW_NOISE}")
    if out["f32_module_f32"]["slots"] < AGREE_MIN:
        raise AssertionError(f"int8 route f32: {out['f32_module_f32']} of "
                             f"the f32 module's slots (< {AGREE_MIN})")

    xg = torch.from_numpy(calib).to(dev)
    gated = try_int8_pipeline(state, ov, xg, twin_calib)
    if gated is None:
        raise AssertionError("try_int8_pipeline: the gate refused the int8 "
                             "path against its CPU twin")
    card = gated(state, xg).cpu()
    same = bool(torch.equal(card, served(calib).cpu()))
    log(f"try_int8_pipeline: gated pipe, impl {gated.impl}, "
        f"{coord_agreement(card, twin_calib):.6f} of the slots of the CPU "
        f"twin, {row_agreement(card, twin_calib)[1]} rows moved; equal to "
        f"the served bf16 route: {same}")
    if not same:
        raise AssertionError("try_int8_pipeline: its coords differ from the "
                             "served bf16 int8 route's on the same batch")
    launched = {k: v for k, v in counts().items() if v}
    if launched:
        raise AssertionError(f"int8 phase: a kernel launched: {launched}")


def export_path(dev, state) -> dict:
    """The artifacts of ``serve.export_pipeline`` at B, L, bf16 on the
    seeded weights, exported, saved, loaded and served on the card: a
    batch-polymorphic one (``batch="b"``), one at the fixed batch B and a
    weightless one (its state from the ``.weights.npz`` sidecar). Each
    prints its export and load seconds and its size, serves a warm-up
    batch and N_BATCHES fresh gate batches, each launching the serving SGB
    kernel and the conv stack once through their custom ops (counts set to
    0 before each artifact's batches), and must give ``make_pipeline``'s
    direct coords on them bit for bit; ms per batch (median) beside the
    direct pipeline's, and the device time of the weight layouts that the
    weightless program runs on every call. Then the daemon from two
    artifacts (``artifact=``, L and L_UNCHUNKED) under
    :func:`daemon_traffic`, half its clients at each length. Returns the
    phase's launches by kernels-line row."""
    rng = np.random.default_rng(SEED + 5)
    ov = {"upsample_factor": UP}
    decode = dict(window_size=DECODE["window_size"],
                  threshold=DECODE["threshold"],
                  max_echoes=DECODE["max_echoes"])
    warm = gate_batch(B, L, rng)
    batches = [gate_batch(B, L, rng) for _ in range(N_BATCHES)]
    direct = make_pipeline(state, ov, device=dev, **decode)

    def run_direct(x):
        return direct(x).cpu()

    run_direct(warm)  # cuDNN's algorithm choice, not timed
    want, direct_ms = serve_timed("export phase direct", run_direct, batches,
                                  SERVE[L])
    out = {"direct_ms_per_batch": float(np.median(direct_ms))}
    launches = {"sgb_contract_pool_dma": 0, "conv_stack_fused": 0}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for kind, batch in (("b", "b"), ("fixed", B), ("weightless", "b")):
            t0 = time.perf_counter()
            if kind == "weightless":
                program, weights = export_pipeline_weightless(
                    state, ov, batch, L, device=dev, **decode)
            else:
                program = export_pipeline(state, ov, batch, L, device=dev,
                                          **decode)
                weights = None
            export_s = time.perf_counter() - t0
            paths[kind] = path = save_pipeline(Path(tmp) / f"{kind}.pt2",
                                               program, weights)
            sidecar = Path(str(path) + ".weights.npz")
            t0 = time.perf_counter()
            served = load_pipeline(path)
            load_s = time.perf_counter() - t0

            def run(x, served=served):
                return served(x).cpu()

            run(warm)
            reset_launch_counts()
            got, batch_ms = serve_timed(f"export {kind}", run, batches,
                                        SERVE[L])
            c = counts()
            launches["sgb_contract_pool_dma"] += c["sgb_dma.launches"]
            launches["conv_stack_fused"] += c["conv_stack.launches"]
            out[kind] = dict(
                export_s=export_s, load_s=load_s,
                file_mb=path.stat().st_size / 1e6,
                sidecar_mb=(sidecar.stat().st_size / 1e6
                            if sidecar.exists() else 0.0),
                in_spec=[str(d) for d in served.in_specs[0].shape],
                equal_to_direct=bool(torch.equal(got, want)),
                ms_per_batch=float(np.median(batch_ms)), batch_ms=batch_ms)
        kernel, bias = contract_bf16(state)
        out["weightless_layout_ms"] = time_ms(lambda: (
            sgb.sgb_dma_weights(kernel, bias, torch.bfloat16),
            conv_stack.stack_weights(state, torch.bfloat16)), [()])
        log(f"export phase: {json.dumps(out)}")
        bad = [k for k in ("b", "fixed", "weightless")
               if not out[k]["equal_to_direct"]]
        if bad:
            raise AssertionError(f"export phase: artifacts {bad} differ from "
                                 f"make_pipeline's direct coords")

        paths["l2000"] = save_pipeline(Path(tmp) / "l2000.pt2",
                                       export_pipeline(
                                           state, ov, "b", L_UNCHUNKED,
                                           device=dev,
                                           max_echoes=DAEMON_ECHOES))
        paths["l8000"] = save_pipeline(Path(tmp) / "l8000.pt2",
                                       export_pipeline(
                                           state, ov, "b", L, device=dev,
                                           max_echoes=DAEMON_ECHOES))
        half = DAEMON_CLIENTS // 2 * DAEMON_REQUESTS
        rows = (list(gate_batch(half, L, rng)[:, 0])
                + list(gate_batch(half, L_UNCHUNKED, rng)[:, 0]))
        args = {"artifact": f"{paths['l8000']},{paths['l2000']}",
                "max_batch": B, "max_wait_ms": 2, "port": 0}
        _, served = daemon_traffic(f"daemon (artifacts L={L}, "
                                   f"{L_UNCHUNKED})", args,
                                   state, dev, rows,
                                   gate_batch(B, L, rng)[:, 0],
                                   dtype=torch.bfloat16)
    if not all(served.values()):
        raise AssertionError(f"daemon from artifacts: a kernel did not "
                             f"launch: {served}")
    for k, v in served.items():
        launches[k] = launches.get(k, 0) + v
    return launches


def default_flags() -> None:
    """PyTorch's own TF32 defaults (cuDNN's on, cuBLAS's off), which a
    daemon process serves under: the phases after the kernel checks run
    with them, their plain references in their own TF32-off scope."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False


def to_cpu(tree):
    """A nested dict of tensors, copied to the CPU."""
    return {k: to_cpu(v) if isinstance(v, dict) else v.cpu()
            for k, v in tree.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    logs = _build.build_all(SOURCES)
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "wgmma")):
                log(f"  {name}: {line.strip()}")
    log(f"card: {card()}")
    rng_new = np.random.default_rng(SEED + 2)  # this slice's phases
    first = canary(dev, rng_new)

    state = StofNet(generator=torch.Generator().manual_seed(SEED),
                    device=dev).state_dict()
    rng = np.random.default_rng(SEED)
    kernels = [kernel_sgb(dev, rng, state), kernel_stack(dev, rng, state),
               *kernels_trainable(dev, rng, state),
               kernel_sgb_dma(dev, rng_new, state)]
    probe_row, probe_launches = probe_path()
    kernels += [probe_row, first]
    for k in kernels:
        log(f"{k['name']}: {k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, "
            f"library {k['library_ms']:.4f}, bound {k['bound_ms']:.4f} ms "
            f"by {k['bound_by']})")

    paths = [probe_launches, main_path(dev, state, rng),
             bench_paths(dev, state, rng_new)["launches"],
             train_path(dev)["launches"]]
    default_flags()
    tf32_rows(dev, state)
    paths.append(daemon_path(dev, state))
    int8_path(dev, state)
    paths.append(export_path(dev, state))
    least = {"stream_probe": len(probe_script.POINTS), "canary": 1}
    for k in kernels:
        k["launches"] = sum(p.get(k["name"], 0) for p in paths)
        need = least.get(k["name"], N_BATCHES)
        if k["launches"] < need:
            raise AssertionError(f"{k['name']} launched {k['launches']} "
                                 f"times on its paths, fewer than {need}")
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
