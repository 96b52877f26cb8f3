"""Fused StofNet conv stack: conv2..conv12 + conv_last in one kernel
(replaces ``stofnet_tpu/ops/pallas/conv_stack_kernel.py:conv_stack_fused``).

``conv_stack_fused`` launches the CUDA kernel ``csrc/conv_stack.cu`` on a
CUDA tensor and runs ``conv_stack_fused_reference`` on a CPU tensor. A
server lays the weights out once (``stack_weights``) and calls
``conv_stack_fused_prepared`` per batch. The
kernel keeps every intermediate activation on the chip; its design and its
bound are in the source's header.
"""

from __future__ import annotations

import ctypes
from typing import Mapping, NamedTuple

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

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)

_P = ctypes.c_void_p
_SIGNATURE = {"conv_stack_launch": [
    _P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, _P]}


class StackWeights(NamedTuple):
    """conv2..conv12 and conv_last in the kernel's layout, built once per
    model by :func:`stack_weights`."""
    mid: torch.Tensor  # (11, C, 7 C) as [layer][n][t * C + c], compute type
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
    last, blast = lay("conv_last", KLAST), bias("conv_last")
    last = torch.cat([last, last.new_zeros((rows - r, last.shape[1]))])
    blast = torch.cat([blast, blast.new_zeros(rows - r)])
    return StackWeights(
        mid.contiguous(),
        torch.stack([bias(f"conv{i}") for i in range(2, NB)]).contiguous(),
        last.contiguous(), blast.contiguous(), r)


def _plain(h0: torch.Tensor, wts: StackWeights) -> torch.Tensor:
    """The stack as a loop of f32 convs on the kernel's layout, each
    layer's output rounded to ``h0.dtype``, conv_last returned in f32."""
    dt, c = h0.dtype, h0.shape[2]

    def conv(x, w, b, k):  # [o][t * C + c] -> flax (K, C, O)
        kernel = w.reshape(-1, k, c).permute(1, 2, 0)
        return conv1d_same(x.float(), kernel.float(), b)

    h = res = res1 = h0
    for layer, i in enumerate(range(2, NB - 1)):
        y = conv(h, wts.mid[layer], wts.mid_bias[layer], KMID)
        if i in RESIDUAL_LAYERS:
            h = res = (res.float() + y).to(dt)
        else:
            h = F.leaky_relu(y, 0.01).to(dt)
    h = (res1.float() + conv(h, wts.mid[-1], wts.mid_bias[-1], KMID)).to(dt)
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
    """:func:`conv_stack_fused` on weights already in the kernel's layout:
    the CUDA kernel on a CUDA tensor, the plain version on a CPU tensor."""
    global launches
    if h0.device.type == "cpu":
        return _plain(h0, wts)
    bsz, length, c = h0.shape
    if (h0.device.type != "cuda" or h0.dtype != torch.bfloat16
            or wts.mid.dtype != torch.bfloat16
            or wts.mid.device != h0.device):
        raise TypeError("conv_stack_fused: the CUDA kernel takes bfloat16 "
                        f"on a CUDA device, got {h0.dtype} on {h0.device} "
                        f"with weights {wts.mid.dtype} on {wts.mid.device}")
    if (c != CHANNELS or wts.mid.shape != (NB - 2, c, KMID * c)
            or wts.last.shape != (MAX_OUT, KLAST * c)):
        raise ValueError("conv_stack_fused: the CUDA kernel takes 64 "
                         "channels, k7 conv2..conv12 and a k3 conv_last with "
                         f"at most {MAX_OUT} outputs")
    out = torch.empty((bsz, length, wts.r), dtype=torch.float32,
                      device=h0.device)
    lib = _build.load("conv_stack", _SIGNATURE)
    err = lib.conv_stack_launch(
        h0.contiguous().data_ptr(), wts.mid.data_ptr(),
        wts.mid_bias.data_ptr(), wts.last.data_ptr(),
        wts.last_bias.data_ptr(), out.data_ptr(), bsz, length, wts.r,
        h0.device.index or 0, torch.cuda.current_stream(h0.device).cuda_stream)
    _build.check(lib, err, "conv_stack_fused")
    launches += 1
    return out
