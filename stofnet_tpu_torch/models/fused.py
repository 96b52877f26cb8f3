"""StofNet forward through the fused kernels (replaces
``stofnet_tpu/models/fused.py:stofnet_apply_fused`` and
``stofnet_apply_packed``).

The same function as ``StofNet(...)(x)``, computed over a state dict, with
the SemiGlobalBlock's contract conv + 80x max-pool in one SGB kernel
(the (B, L, 512) pre-pool tensor never reaches device memory) and
conv2..conv_last in ``ops/kernels/conv_stack.py``. Outside training, a
conv1 of (64, 1, 9) runs with its bias and ReLU as a third kernel
(``ops/kernels/conv1.py``), which writes the contiguous (B, L, 64) rows
the other two read. On a CUDA tensor the three run as CUDA kernels; on a
CPU tensor as their plain versions. The expand conv, the upsample, the
shuffle and the decode stay plain PyTorch.

``trainable=True`` is the training forward: the contract path goes through
``sgb_contract_pool_trainable`` (kernel A forward, kernel B backward) and
the conv stack runs as plain convs, which autograd differentiates (the
stack kernel has no backward in either package). The state may then hold
f32 ``nn.Parameter`` masters: every weight is cast to ``dtype`` inside the
differentiated function, so the gradients come back in f32.

The SGB kernel is the serving instantiation of the streamed kernel
(``ops/kernels/sgb.py:sgb_contract_pool_prepared``) at every L % 80 == 0,
on the one weight layout ``sgb_dma_weights`` builds. ``sgb_impl`` stays in
the signatures for parity with the JAX function, whose ``"tile"`` and
``"dma"`` pick two Pallas kernels of one function; here both run the same
kernel, and an unknown value raises.

Every SGB kernel and its plain version pool a fixed 80 samples, so the
fused forward (``stofnet_apply_fused``, ``fused_forward`` with or without
``trainable``, ``stofnet_apply_reference``) raises ValueError for a
``semi_global_scale`` other than 1 (no SemiGlobalBlock) or 80. This
departs from the JAX function, which pools 80 and repeats by the scale,
serving another function without an error; ``serve.make_pipeline`` runs
the ``StofNet`` module for such a checkpoint.

``stofnet_apply_packed`` is the position-packed forward (plain PyTorch,
``ops/packed_conv.py``): the same math, no kernel.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch
import torch.nn.functional as F

from stofnet_tpu_torch.ops.conv import conv1d_same
from stofnet_tpu_torch.ops.kernels import conv1 as conv1_kernel
from stofnet_tpu_torch.ops.kernels.conv_stack import (
    NB, conv_stack_fused_prepared, conv_stack_fused_reference, stack_weights,
)
from stofnet_tpu_torch.ops.kernels.sgb import (
    CHANNELS, GROUP, POOL, sgb_contract_pool, sgb_contract_pool_prepared,
    sgb_contract_pool_reference, sgb_contract_pool_trainable,
    sgb_dma_weights,
)
from stofnet_tpu_torch.ops.packed_conv import (
    conv1d_blocked, conv1d_same_packed,
)
from stofnet_tpu_torch.ops.shuffle import sample_shuffle

CONTRACT = "semi_global_block.contract_conv"
SGB_IMPLS = ("tile", "dma")
FUSED_SCALES = (1, POOL)  # the semi_global_scale values the forward computes


def stofnet_apply_fused(
    state: Mapping[str, torch.Tensor],
    x: torch.Tensor,
    upsample_factor: int = 4,
    num_blocks: int = 13,
    semi_global_scale: int = 80,
    dtype: Optional[torch.dtype] = torch.bfloat16,
    fused_stack: bool = True,
    trainable: bool = False,
    sgb_impl: str = "dma",
) -> torch.Tensor:
    """StofNet forward, (B, 1, L) -> (B, 1, L*r) f32, in the channels-last
    (B, L, C) layout of the JAX function.

    ``state`` holds the reference torch names and layouts, on ``x``'s
    device. ``dtype=None`` computes in f32 (the CPU only: the CUDA kernels
    take bfloat16). ``fused_stack=False``, or a ``num_blocks`` other than
    13, runs the conv stack as separate plain convs. ``trainable=True`` is
    differentiable in ``state`` and ``x`` (module docstring) and implies
    ``fused_stack=False``. ``sgb_impl`` (``"tile"`` or ``"dma"``) is
    checked and chooses nothing (module docstring). Raises ValueError for
    a ``semi_global_scale`` other than 1 or 80 (module docstring).
    """
    return fused_forward(state, upsample_factor, num_blocks,
                         semi_global_scale, dtype, fused_stack, trainable,
                         sgb_impl)(x)


def fused_forward(
    state: Mapping[str, torch.Tensor],
    upsample_factor: int = 4,
    num_blocks: int = 13,
    semi_global_scale: int = 80,
    dtype: Optional[torch.dtype] = torch.bfloat16,
    fused_stack: bool = True,
    trainable: bool = False,
    sgb_impl: str = "dma",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """:func:`stofnet_apply_fused` as a callable of ``x`` that lays the
    kernels' weights out once, on the state's device: the forward a server
    closes over. With ``trainable`` nothing is laid out ahead: the weights
    change every step. The SGB kernel's one layout, the
    ``sgb_dma_weights`` image, is laid out on every device where the
    contract conv is (5, 64, F) with F % 64 == 0, so the forward calls the
    same two custom ops on the CPU (their plain versions, which round the
    weights where the plain version on (w, b) does) and on the card (the
    kernels): one traced graph for both. Otherwise nothing is laid out, and
    each call runs ``sgb_contract_pool`` on (w, b): the plain version on a
    CPU tensor, and on a CUDA tensor the kernel, which raises for weights
    it does not take. ``stack_weights`` lays out the conv stack. Where
    conv1's weight is (64, 1, 9), ``conv1_weights`` rounds it and its bias
    once and every call runs the conv1 op (plain on the CPU, the kernel on
    the card, bfloat16 only); any other conv1 stays the plain conv."""
    _check_sgb_impl(sgb_impl)
    _check_scale(semi_global_scale)
    if trainable:
        def sgb_train(h):
            return sgb_contract_pool_trainable(h, *_kernel_and_bias(
                state, CONTRACT))

        def forward_train(x: torch.Tensor) -> torch.Tensor:
            return _apply(state, x, sgb_train, None, upsample_factor,
                          num_blocks, semi_global_scale, dtype)
        return forward_train
    dt = torch.float32 if dtype is None else dtype
    sgb = stack = conv1 = None
    if conv1_kernel.takes(state["conv1.weight"]):
        w1, b1 = conv1_kernel.conv1_weights(state["conv1.weight"],
                                            state["conv1.bias"], dt)

        def conv1(x):
            return conv1_kernel.conv1_relu_rows(x, w1, b1)
    if semi_global_scale != 1:
        kernel, b = _kernel_and_bias(state, CONTRACT)
        image = None
        if kernel.shape[1] == CHANNELS and kernel.shape[2] % GROUP == 0:
            image, bias = sgb_dma_weights(kernel, b, dt)

        def sgb(h):
            if image is None:
                return sgb_contract_pool(h, kernel, b)
            return sgb_contract_pool_prepared(h, image, bias)
    if fused_stack and num_blocks == NB:
        wts = stack_weights(state, dt)

        def stack(h):
            return conv_stack_fused_prepared(h, wts)

    def forward(x: torch.Tensor) -> torch.Tensor:
        return _apply(state, x, sgb, stack, upsample_factor, num_blocks,
                      semi_global_scale, dtype, conv1)
    return forward


def stofnet_apply_reference(
    state: Mapping[str, torch.Tensor],
    x: torch.Tensor,
    upsample_factor: int = 4,
    num_blocks: int = 13,
    semi_global_scale: int = 80,
    dtype: Optional[torch.dtype] = torch.bfloat16,
    fused_stack: bool = True,
    trainable: bool = False,
    sgb_impl: str = "dma",
) -> torch.Tensor:
    """:func:`stofnet_apply_fused` with the kernels' plain versions on any
    device: the same function with the same rounding points, so the two
    differ only by the order of f32 sums. The plain path the card's
    kernel path is held against; ``trainable`` runs the plain versions of
    kernels A and B. ``sgb_impl`` is only checked and
    ``semi_global_scale`` refused, as there."""
    _check_sgb_impl(sgb_impl)
    _check_scale(semi_global_scale)

    def sgb(h):
        if trainable:
            return sgb_contract_pool_trainable(
                h, *_kernel_and_bias(state, CONTRACT), plain=True)
        return sgb_contract_pool_reference(h, *_kernel_and_bias(
            state, CONTRACT))

    def stack(h):
        return conv_stack_fused_reference(h, state)
    return _apply(state, x, sgb, stack if fused_stack and num_blocks == NB
                  and not trainable else None, upsample_factor, num_blocks,
                  semi_global_scale, dtype)


def stofnet_apply_packed(
    state: Mapping[str, torch.Tensor],
    x: torch.Tensor,
    upsample_factor: int = 4,
    num_blocks: int = 13,
    semi_global_scale: int = 80,
    dtype: Optional[torch.dtype] = torch.bfloat16,
    pack: int = 2,
) -> torch.Tensor:
    """StofNet forward with position-packed convs, (B, 1, L) -> (B, 1, L*r)
    f32: the same math as ``StofNet(...)(x)`` with each conv rounding where
    flax does (inputs, weights and bias in ``dtype``, the conv output and
    the bias add each rounded). conv1 packs ``pack`` positions; the SGB's
    convs stay plain (contract conv, leaky, 80x max-pool, expand conv);
    conv2..conv12 enter the blocked (B, L/P, P * 64) domain once and chain
    in it (P = ``pack`` where it divides L, else 1); conv_last packs the
    largest of 32, 16, 8, 4, 2 that divides L."""
    def cast(h, name):  # flax's casts: input, kernel and bias in dtype
        kernel, bias = _kernel_and_bias(state, name)
        if dtype is not None:
            h, kernel, bias = h.to(dtype), kernel.to(dtype), bias.to(dtype)
        return h, kernel, bias

    def conv(h, name, pk):
        return conv1d_same_packed(*cast(h, name), pack=pk)

    h = x.transpose(1, 2)
    if dtype is not None:
        h = h.to(dtype)
    length = h.shape[1]
    h = F.relu(conv(h, "conv1", pack))

    if semi_global_scale != 1:
        s = F.leaky_relu(conv(h, CONTRACT, 1), 0.01)
        s = F.max_pool1d(s.transpose(1, 2), semi_global_scale).transpose(1, 2)
        s = F.leaky_relu(conv(s, "semi_global_block.expand_conv", 1), 0.01)
        s = torch.repeat_interleave(s, semi_global_scale, dim=1)
        pad = max(0, length - s.shape[1])
        h = h + F.pad(s, (0, 0, pad // 2, pad // 2))

    # the blocked domain, entered once (a block of 1 is the plain conv)
    pk = pack if pack > 1 and length % pack == 0 else 1
    nf = h.shape[-1]
    h = h.reshape(h.shape[0], length // pk, pk * nf)

    def conv_blocked(hb, name):
        return conv1d_blocked(*cast(hb, name), pk)

    residual_layers = set(range(3, num_blocks - 1, 2))
    res = res1 = h
    for i in range(2, num_blocks - 1):
        y = conv_blocked(h, f"conv{i}")
        if i in residual_layers:
            h = res = res + y
        else:
            h = F.leaky_relu(y, 0.01)
    h = res1 + conv_blocked(h, f"conv{num_blocks - 1}")
    h = h.reshape(h.shape[0], length, nf)

    pk_last = next((c for c in (32, 16, 8, 4, 2) if length % c == 0), 1)
    h = conv(h, "conv_last", pk_last)
    return sample_shuffle(h.transpose(1, 2), upsample_factor).to(torch.float32)


def _check_sgb_impl(sgb_impl):
    if sgb_impl not in SGB_IMPLS:
        raise ValueError(f"sgb_impl={sgb_impl!r}, not one of {SGB_IMPLS}")


def _check_scale(semi_global_scale):
    if semi_global_scale not in FUSED_SCALES:
        raise ValueError(f"semi_global_scale={semi_global_scale}: the SGB "
                         f"kernels pool a fixed {POOL} samples, so the fused "
                         f"forward computes only {FUSED_SCALES} (serve the "
                         f"StofNet module for any other)")


def _kernel_and_bias(state, name):
    """Torch (O, I, K) weight -> flax (K, I, O) kernel, and the bias."""
    return state[f"{name}.weight"].permute(2, 1, 0), state[f"{name}.bias"]


def _apply(state, x, sgb, stack, upsample_factor, num_blocks,
           semi_global_scale, dtype, conv1=None):
    """The forward around the kernel blocks: ``conv1(x)`` (conv1 + ReLU as
    (B, L, C) rows; the plain conv when None), ``sgb(h)`` (the contract
    conv + pool) and ``stack(h)`` (conv2..conv_last; plain convs when
    None)."""
    def kb(name):
        return _kernel_and_bias(state, name)

    if conv1 is not None:
        h = conv1(x)
    else:
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
