"""Fused StofNet conv stack: conv2..conv12 + conv_last in one kernel
(replaces ``stofnet_tpu/ops/pallas/conv_stack_kernel.py:conv_stack_fused``).

``conv_stack_fused`` launches the CUDA kernel ``csrc/conv_stack.cu`` on a
CUDA tensor and runs ``conv_stack_fused_reference`` on a CPU tensor. A
server lays the weights out once (``stack_weights``) and calls
``conv_stack_fused_prepared`` per batch, which calls the custom op
``stofnet_torch::conv_stack_fused_prepared`` (registered when this module
is imported): its CUDA implementation is the launch, its CPU
implementation the plain version, its fake implementation the output's
shape for ``torch.export``. The
kernel keeps every intermediate activation on the chip; its design and its
bound are in the source's header. Two pieces of that design live here in
plain Python, where the CPU tests reach them: the tile plan
(:func:`tile_plan`, which the wrapper hands the kernel as
:func:`launch_plan`) and the weights' shared-memory image
(:func:`stack_weights`, undone by :func:`mid_plain`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Mapping, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from stofnet_tpu_torch.ops.conv import conv1d_same
from stofnet_tpu_torch.ops.kernels import _build

NB = 13  # num_blocks: conv2..conv12 are the stack's k7 layers
CHANNELS = 64
KMID = 7
KLAST = 3
MAX_OUT = 8  # conv_last outputs the kernel computes (one n8 tile)
RESIDUAL_LAYERS = frozenset(range(3, NB - 1, 2))
ROWS = 512  # rows of a kernel tile
HALO = (NB - 2) * (KMID // 2) + KLAST // 2  # receptive half-width, 34
KEEP_EDGE = ROWS - HALO  # positions kept by a tile at a sequence end, 478
KEEP_MID = ROWS - 2 * HALO  # positions kept by any other tile, 444

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)
COUNTERS = ("launches",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURE = {"conv_stack_launch": [
    _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]}


def tile_plan(length: int) -> Tuple[List[int], List[Tuple[int, int]]]:
    """The kernel's tiles over one waveform of ``length`` positions: the
    first position of each tile's ROWS rows, and the range [lo, hi) of
    positions it writes. Edge tiles are anchored on the sequence ends, whose
    zero padding is the stack's own, so they keep KEEP_EDGE positions;
    every other tile keeps KEEP_MID, HALO from either edge. The kept ranges
    are disjoint and cover [0, length). A waveform of at most ROWS
    positions is one tile, its rows past the end held at zero."""
    if length <= ROWS:
        return [0], [(0, length)]
    mid = max(0, -(-(length - 2 * KEEP_EDGE) // KEEP_MID))
    starts, kept = [0], [(0, KEEP_EDGE)]
    for j in range(mid):
        lo = KEEP_EDGE + j * KEEP_MID
        starts.append(lo - HALO)
        kept.append((lo, lo + KEEP_MID))
    starts.append(length - ROWS)
    kept.append((KEEP_EDGE + mid * KEEP_MID, length))
    return starts, kept


@functools.lru_cache(maxsize=None)
def launch_plan(length: int, device: torch.device) -> torch.Tensor:
    """:func:`tile_plan` as the kernel takes it: one int32 row (start, lo,
    hi) per tile of a waveform, on ``device``; built once per length."""
    starts, kept = tile_plan(length)
    return torch.tensor([(s, lo, hi) for s, (lo, hi) in zip(starts, kept)],
                        dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=None)
def tap_block_index(device: torch.device) -> torch.Tensor:
    """Where element (n, k) of a 64 x 64 tap block lies in its flat
    shared-memory image: rows of 64 values (128 bytes in bf16), the 16-byte
    chunk j of row n moved to chunk j ^ (n % 8), the 128-byte swizzle
    ``wgmma`` reads. Built once per device: a forward that lays its
    weights out per call copies no index to the card."""
    n = torch.arange(CHANNELS)[:, None]
    k = torch.arange(CHANNELS)[None, :]
    return (n * CHANNELS + ((k // 8) ^ (n % 8)) * 8 + k % 8).reshape(-1).to(
        device)


class StackWeights(NamedTuple):
    """conv2..conv12 and conv_last in the kernel's layout, built once per
    model by :func:`stack_weights`."""
    mid: torch.Tensor  # (11, 7, C * C): tap block [layer][t] of w[n][c],
    # swizzled (tap_block_index), compute type; mid_plain undoes it
    mid_bias: torch.Tensor  # (11, C) f32, rounded to the compute type
    last: torch.Tensor  # (max(r, 8), 3 C) as [n][t * C + c], rows >= r zero
    last_bias: torch.Tensor  # (max(r, 8),) f32, rounded; zero from r on
    r: int  # conv_last outputs, the upsample factor


def stack_weights(state: Mapping[str, torch.Tensor], dtype: torch.dtype,
                  device=None) -> StackWeights:
    """Lay out the stack's weights for the kernel: rounded to ``dtype``
    (biases held in f32), on ``device`` (the state's when None)."""
    def lay(name, k):  # torch (O, I, K) -> [o][t * I + i]
        w = state[f"{name}.weight"].to(device=device, dtype=dtype)
        if w.shape[2] != k:
            raise ValueError(f"conv_stack: {name} has kernel size "
                             f"{w.shape[2]}, the stack takes {k}")
        return w.permute(0, 2, 1).reshape(w.shape[0], -1)

    def bias(name):
        return state[f"{name}.bias"].to(device=device, dtype=dtype).float()

    r = state["conv_last.weight"].shape[0]
    rows = max(r, MAX_OUT)
    mid = torch.stack([lay(f"conv{i}", KMID) for i in range(2, NB)])
    n_mid, c = mid.shape[0], CHANNELS
    if mid.shape[1:] != (c, KMID * c):
        raise ValueError(f"conv_stack: the stack takes {c} channels, got "
                         f"conv2..conv12 of {tuple(mid.shape[1:])}")
    blocks = mid.reshape(n_mid, c, KMID, c).permute(0, 2, 1, 3)
    image = torch.empty((n_mid, KMID, c * c), dtype=dtype, device=mid.device)
    image[:, :, tap_block_index(mid.device)] = blocks.reshape(
        n_mid, KMID, c * c)
    last, blast = lay("conv_last", KLAST), bias("conv_last")
    last = torch.cat([last, last.new_zeros((rows - r, last.shape[1]))])
    blast = torch.cat([blast, blast.new_zeros(rows - r)])
    return StackWeights(
        image,
        torch.stack([bias(f"conv{i}") for i in range(2, NB)]).contiguous(),
        last.contiguous(), blast.contiguous(), r)


def mid_plain(wts: StackWeights) -> torch.Tensor:
    """conv2..conv12 as (11, C, 7 C) [layer][n][t * C + c]: the swizzled
    tap blocks of ``wts.mid`` read back in order."""
    n_mid, k, c = wts.mid.shape[0], KMID, CHANNELS
    blocks = wts.mid[:, :, tap_block_index(wts.mid.device)].reshape(
        n_mid, k, c, c)
    return blocks.permute(0, 2, 1, 3).reshape(n_mid, c, k * c)


def _plain(h0: torch.Tensor, wts: StackWeights) -> torch.Tensor:
    """The stack as a loop of f32 convs on the kernel's layout, each
    layer's output rounded to ``h0.dtype``, conv_last returned in f32."""
    dt, c = h0.dtype, h0.shape[2]
    mid = mid_plain(wts)

    def conv(x, w, b, k):  # [o][t * C + c] -> flax (K, C, O)
        kernel = w.reshape(-1, k, c).permute(1, 2, 0)
        return conv1d_same(x.float(), kernel.float(), b)

    h = res = res1 = h0
    for layer, i in enumerate(range(2, NB - 1)):
        y = conv(h, mid[layer], wts.mid_bias[layer], KMID)
        if i in RESIDUAL_LAYERS:
            h = res = (res.float() + y).to(dt)
        else:
            h = F.leaky_relu(y, 0.01).to(dt)
    h = (res1.float() + conv(h, mid[-1], wts.mid_bias[-1], KMID)).to(dt)
    return conv(h, wts.last[:wts.r], wts.last_bias[:wts.r], KLAST)


def conv_stack_fused_reference(h0: torch.Tensor,
                               state: Mapping[str, torch.Tensor]
                               ) -> torch.Tensor:
    """Plain version at the kernel's rounding points: weights and biases
    rounded to ``h0.dtype``, each conv in f32, each layer's output rounded
    to ``h0.dtype``, conv_last returned in f32."""
    return _plain(h0, stack_weights(state, h0.dtype, h0.device))


def conv_stack_fused(h0: torch.Tensor,
                     state: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Run conv2..conv_last on conv1+SGB features: :func:`stack_weights`
    on ``h0``'s device, then :func:`conv_stack_fused_prepared`.

    Args:
        h0: (B, L, 64) features after conv1 and the SemiGlobalBlock;
            bfloat16 on a CUDA device.
        state: StofNet state dict with the reference torch names
            (``conv2.weight`` .. ``conv12.bias``, ``conv_last.*``).
    Returns: (B, L, upsample_factor) pre-shuffle heatmap channels, f32.
    """
    return conv_stack_fused_prepared(
        h0, stack_weights(state, h0.dtype, h0.device))


def conv_stack_fused_prepared(h0: torch.Tensor,
                              wts: StackWeights) -> torch.Tensor:
    """:func:`conv_stack_fused` on weights already in the kernel's layout,
    through the custom op ``stofnet_torch::conv_stack_fused_prepared``
    (the NamedTuple passed as its four tensors and ``r``): the CUDA kernel
    on a CUDA tensor, the plain version on a CPU tensor."""
    return torch.ops.stofnet_torch.conv_stack_fused_prepared(
        h0, wts.mid, wts.mid_bias, wts.last, wts.last_bias, wts.r)


def _check(h0: torch.Tensor, mid: torch.Tensor, last: torch.Tensor) -> None:
    """What the CUDA kernel takes, checked for a CUDA (or fake CUDA)
    tensor without reading storage; the plain version takes the rest."""
    if h0.device.type == "cpu":
        return
    c = h0.shape[2]
    if (h0.device.type != "cuda" or h0.dtype != torch.bfloat16
            or mid.dtype != torch.bfloat16 or mid.device != h0.device):
        raise TypeError("conv_stack_fused: the CUDA kernel takes bfloat16 "
                        f"on a CUDA device, got {h0.dtype} on {h0.device} "
                        f"with weights {mid.dtype} on {mid.device}")
    if (c != CHANNELS or mid.shape != (NB - 2, KMID, c * c)
            or last.shape != (MAX_OUT, KLAST * c)):
        raise ValueError("conv_stack_fused: the CUDA kernel takes 64 "
                         "channels, k7 conv2..conv12 and a k3 conv_last with "
                         f"at most {MAX_OUT} outputs")


# The stack kernel as a custom op, so that torch.export traces it and a
# saved program names it. Registering builds nothing: nvcc runs at the
# first launch.
@torch.library.custom_op("stofnet_torch::conv_stack_fused_prepared",
                         mutates_args=(), device_types="cpu")
def _stack_op(h0: torch.Tensor, mid: torch.Tensor, mid_bias: torch.Tensor,
              last: torch.Tensor, last_bias: torch.Tensor,
              r: int) -> torch.Tensor:
    """The CPU implementation: the plain version, contiguous as the
    kernel's output."""
    return _plain(h0, StackWeights(mid, mid_bias, last, last_bias,
                                   r)).contiguous()


@_stack_op.register_kernel("cuda")
def _stack_cuda(h0: torch.Tensor, mid: torch.Tensor, mid_bias: torch.Tensor,
                last: torch.Tensor, last_bias: torch.Tensor,
                r: int) -> torch.Tensor:
    """The CUDA implementation: the kernel's launch, which counts."""
    global launches
    _check(h0, mid, last)
    bsz, length, _ = h0.shape
    # the copies stay referenced until the launch is queued: a copy freed
    # before it could be handed to another thread's work, queued first
    h0, mid, mid_bias, last, last_bias = (
        t.contiguous() for t in (h0, mid, mid_bias, last, last_bias))
    out = torch.empty((bsz, length, r), dtype=torch.float32,
                      device=h0.device)
    plan = launch_plan(length, h0.device)
    lib = _build.load("conv_stack", _SIGNATURE)
    err = lib.conv_stack_launch(
        h0.data_ptr(), mid.data_ptr(), mid_bias.data_ptr(), last.data_ptr(),
        last_bias.data_ptr(), out.data_ptr(), plan.data_ptr(), plan.shape[0],
        bsz, length, r, *_build.launch_args(h0))
    _build.check(lib, err, "conv_stack_fused")
    launches += 1
    return out


@_stack_op.register_fake
def _stack_fake(h0: torch.Tensor, mid: torch.Tensor, mid_bias: torch.Tensor,
                last: torch.Tensor, last_bias: torch.Tensor,
                r: int) -> torch.Tensor:
    """The shape of the output, (B, L, r) f32, after the same checks, so
    that a program the kernel would refuse fails at export."""
    _check(h0, mid, last)
    bsz, length, _ = h0.shape
    return h0.new_empty((bsz, length, r), dtype=torch.float32)
