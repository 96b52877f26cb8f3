"""StofNet's conv1 with its bias and ReLU in one kernel that writes the
(B, L, 64) rows the SGB and conv-stack kernels read (no JAX counterpart:
conv1 was XLA's in the JAX package).

``conv1_relu_rows`` calls the custom op ``stofnet_torch::conv1_relu_rows``
(registered when this module is imported): its CUDA implementation
launches ``csrc/conv1_rows.cu``, its CPU implementation is the plain
version (:func:`conv1_relu_rows_reference`, returned contiguous), its fake
implementation the output's shape for ``torch.export``. It takes the
frames as they come, (B, 1, L), and conv1's torch weight (64, 1, 9) and
bias rounded to the compute type once (:func:`conv1_weights`); the output
is contiguous (B, L, 64) in that type. The kernel's design and its bound
are in the source's header.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from stofnet_tpu_torch.ops.conv import conv1d_same
from stofnet_tpu_torch.ops.kernels import _build

CHANNELS = 64
KSIZE = 9
SHAPE = (CHANNELS, 1, KSIZE)  # the conv1 weight the op computes (torch's)

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)
COUNTERS = ("launches",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURE = {"conv1_rows_launch": [_P, _P, _P, _P, _I, _I, _I, _P]}


def takes(weight: torch.Tensor) -> bool:
    """Whether conv1's torch weight is the (64, 1, 9) the op computes."""
    return tuple(weight.shape) == SHAPE


def conv1_weights(weight: torch.Tensor, bias: torch.Tensor,
                  dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """conv1's torch weight (64, 1, 9) and bias rounded to ``dtype``, as
    the op takes them; a forward lays them out once."""
    return weight.to(dtype).contiguous(), bias.to(dtype).contiguous()


def conv1_relu_rows_reference(x: torch.Tensor, weight: torch.Tensor,
                              bias: torch.Tensor) -> torch.Tensor:
    """Plain version: ``relu(conv1d_same(x, w, b, dtype))`` on the frames
    as (B, L, 1), in ``weight``'s type: x rounds to it, the conv output
    and the bias add each round to it."""
    dt = weight.dtype
    h = x.transpose(1, 2).to(dt)
    return F.relu(conv1d_same(h, weight.permute(2, 1, 0), bias, dt))


def conv1_relu_rows(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """conv1 + bias + ReLU of the (B, 1, L) frames ``x`` as contiguous
    (B, L, 64) rows in ``weight``'s type, through the custom op: the CUDA
    kernel on a CUDA tensor (bfloat16 weights only), the plain version on
    a CPU tensor."""
    return torch.ops.stofnet_torch.conv1_relu_rows(x, weight, bias)


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> None:
    """The op's shape, type and device checks, storage not read (a fake
    tensor of a traced program is checked as a real one)."""
    if (x.dim() != 3 or x.shape[1] != 1 or tuple(weight.shape) != SHAPE
            or tuple(bias.shape) != (CHANNELS,)):
        raise ValueError(f"conv1_relu_rows: takes frames (B, 1, L), a "
                         f"weight {SHAPE} and a bias ({CHANNELS},), got "
                         f"{tuple(x.shape)}, {tuple(weight.shape)}, "
                         f"{tuple(bias.shape)}")
    if x.device.type == "cpu":
        return
    if (x.device.type != "cuda" or weight.dtype != torch.bfloat16
            or bias.dtype != torch.bfloat16 or weight.device != x.device
            or bias.device != x.device):
        raise TypeError("conv1_relu_rows: the CUDA kernel takes bfloat16 "
                        f"weights on the frames' CUDA device, got "
                        f"{weight.dtype} on {weight.device} for frames on "
                        f"{x.device}")


# The kernel as a custom op, so that torch.export traces it and a saved
# program names it. Registering builds nothing: nvcc runs at the first
# launch.
@torch.library.custom_op("stofnet_torch::conv1_relu_rows", mutates_args=(),
                         device_types="cpu")
def _conv1_op(x: torch.Tensor, weight: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """The CPU implementation: the plain version, contiguous as the
    kernel's output."""
    _check(x, weight, bias)
    return conv1_relu_rows_reference(x, weight, bias).contiguous()


@_conv1_op.register_kernel("cuda")
def _conv1_cuda(x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """The CUDA implementation: the kernel's launch, which counts. The
    kernel reads f32 frames (those of every pipeline; other types are
    cast first) and rounds them to bfloat16 itself."""
    global launches
    _check(x, weight, bias)
    bsz, _, length = x.shape
    x = x.float().contiguous()
    weight, bias = weight.contiguous(), bias.contiguous()
    out = torch.empty((bsz, length, CHANNELS), dtype=torch.bfloat16,
                      device=x.device)
    lib = _build.load("conv1_rows", _SIGNATURE)
    err = lib.conv1_rows_launch(x.data_ptr(), weight.data_ptr(),
                                bias.data_ptr(), out.data_ptr(), bsz, length,
                                *_build.launch_args(x))
    _build.check(lib, err, "conv1_relu_rows")
    launches += 1
    return out


@_conv1_op.register_fake
def _conv1_fake(x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """The shape of the output, (B, L, 64) in the weight's type, after the
    same checks, so that a program the kernel would refuse fails at
    export."""
    _check(x, weight, bias)
    return x.new_empty((x.shape[0], x.shape[2], CHANNELS), dtype=weight.dtype)
