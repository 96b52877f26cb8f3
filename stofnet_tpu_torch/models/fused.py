"""StofNet inference forward through the fused kernels (replaces
``stofnet_tpu/models/fused.py:stofnet_apply_fused``).

The same function as ``StofNet(...)(x)``, computed over a state dict, with
the SemiGlobalBlock's contract conv + 80x max-pool in
``ops/kernels/sgb.py`` (the (B, L, 512) pre-pool tensor never reaches
device memory) and conv2..conv_last in ``ops/kernels/conv_stack.py``. On a
CUDA tensor both run as CUDA kernels; on a CPU tensor as their plain
versions. conv1, the expand conv, the upsample, the shuffle and the decode
stay plain PyTorch.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch
import torch.nn.functional as F

from stofnet_tpu_torch.ops.conv import conv1d_same
from stofnet_tpu_torch.ops.kernels.conv_stack import (
    NB, conv_stack_fused_prepared, conv_stack_fused_reference, stack_weights,
)
from stofnet_tpu_torch.ops.kernels.sgb import (
    sgb_contract_pool_prepared, sgb_contract_pool_reference, sgb_weights,
)
from stofnet_tpu_torch.ops.shuffle import sample_shuffle

CONTRACT = "semi_global_block.contract_conv"


def stofnet_apply_fused(
    state: Mapping[str, torch.Tensor],
    x: torch.Tensor,
    upsample_factor: int = 4,
    num_blocks: int = 13,
    semi_global_scale: int = 80,
    dtype: Optional[torch.dtype] = torch.bfloat16,
    fused_stack: bool = True,
) -> torch.Tensor:
    """StofNet forward, (B, 1, L) -> (B, 1, L*r) f32, in the channels-last
    (B, L, C) layout of the JAX function.

    ``state`` holds the reference torch names and layouts, on ``x``'s
    device. ``dtype=None`` computes in f32 (the CPU only: the CUDA kernels
    take bfloat16). ``fused_stack=False``, or a ``num_blocks`` other than
    13, runs the conv stack as separate plain convs.
    """
    return fused_forward(state, upsample_factor, num_blocks,
                         semi_global_scale, dtype, fused_stack)(x)


def fused_forward(
    state: Mapping[str, torch.Tensor],
    upsample_factor: int = 4,
    num_blocks: int = 13,
    semi_global_scale: int = 80,
    dtype: Optional[torch.dtype] = torch.bfloat16,
    fused_stack: bool = True,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """:func:`stofnet_apply_fused` as a callable of ``x`` that lays the
    kernels' weights out once (``sgb_weights``, ``stack_weights``), on the
    state's device: the forward a server closes over."""
    dt = torch.float32 if dtype is None else dtype
    sgb = stack = None
    if semi_global_scale != 1:
        wt, bias = sgb_weights(*_kernel_and_bias(state, CONTRACT), dt)

        def sgb(h):
            return sgb_contract_pool_prepared(h, wt, bias)
    if fused_stack and num_blocks == NB:
        wts = stack_weights(state, dt)

        def stack(h):
            return conv_stack_fused_prepared(h, wts)

    def forward(x: torch.Tensor) -> torch.Tensor:
        return _apply(state, x, sgb, stack, upsample_factor, num_blocks,
                      semi_global_scale, dtype)
    return forward


def stofnet_apply_reference(
    state: Mapping[str, torch.Tensor],
    x: torch.Tensor,
    upsample_factor: int = 4,
    num_blocks: int = 13,
    semi_global_scale: int = 80,
    dtype: Optional[torch.dtype] = torch.bfloat16,
    fused_stack: bool = True,
) -> torch.Tensor:
    """:func:`stofnet_apply_fused` with the kernels' plain versions on any
    device: the same function with the same rounding points, so the two
    differ only by the order of f32 sums. The plain path the card's
    kernel path is held against."""
    def sgb(h):
        return sgb_contract_pool_reference(h, *_kernel_and_bias(
            state, CONTRACT))

    def stack(h):
        return conv_stack_fused_reference(h, state)
    return _apply(state, x, sgb, stack if fused_stack and num_blocks == NB
                  else None, upsample_factor, num_blocks, semi_global_scale,
                  dtype)


def _kernel_and_bias(state, name):
    """Torch (O, I, K) weight -> flax (K, I, O) kernel, and the bias."""
    return state[f"{name}.weight"].permute(2, 1, 0), state[f"{name}.bias"]


def _apply(state, x, sgb, stack, upsample_factor, num_blocks,
           semi_global_scale, dtype):
    """The forward around the two kernel blocks: ``sgb(h)`` (the contract
    conv + pool) and ``stack(h)`` (conv2..conv_last; plain convs when
    None)."""
    def kb(name):
        return _kernel_and_bias(state, name)

    h = x.transpose(1, 2)
    if dtype is not None:
        h = h.to(dtype)
    h = F.relu(conv1d_same(h, *kb("conv1"), dtype))

    if semi_global_scale != 1:
        s = conv1d_same(sgb(h), *kb("semi_global_block.expand_conv"), dtype)
        s = F.leaky_relu(s, 0.01)
        s = torch.repeat_interleave(s, semi_global_scale, dim=1)
        pad = max(0, h.shape[1] - s.shape[1])
        h = h + F.pad(s, (0, 0, pad // 2, pad // 2))

    if stack is not None:
        h = stack(h)  # (B, L, r) f32
    else:
        residual_layers = set(range(3, num_blocks - 1, 2))
        res = res1 = h
        for i in range(2, num_blocks - 1):
            y = conv1d_same(h, *kb(f"conv{i}"), dtype)
            if i in residual_layers:
                h = res = res + y
            else:
                h = F.leaky_relu(y, 0.01)
        h = res1 + conv1d_same(h, *kb(f"conv{num_blocks - 1}"), dtype)
        h = conv1d_same(h, *kb("conv_last"), dtype)
    return sample_shuffle(h.transpose(1, 2), upsample_factor).to(torch.float32)
