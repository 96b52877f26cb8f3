"""SemiGlobalBlock contract path with the input streamed through a copy ring:
conv1d(k5, 64->F) + 80x max-pool + leaky (replaces both
``stofnet_tpu/ops/pallas/sgb_dma_kernel.py:sgb_contract_pool_dma`` and
``stofnet_tpu/ops/pallas/sgb_kernel.py:sgb_contract_pool``, which compute
one function).

``sgb_contract_pool_dma`` launches the serving instantiation of the CUDA
kernel ``csrc/sgb_contract_pool_dma.cu`` on a CUDA tensor and runs
``sgb_contract_pool_dma_reference`` on a CPU tensor, for the shapes of
:func:`dma_supported` (every L % 80 == 0). A server lays the weights out
once with :func:`sgb_dma_weights` (the kernel's shared-memory image of
them, undone by :func:`dma_weights_plain`; both live in ``sgb``, whose
kernel A takes the same image) and calls ``sgb_contract_pool_dma_prepared``
per batch: the one launch path of the serving instantiation, which
``sgb.sgb_contract_pool_prepared`` calls too. It calls the custom op
``stofnet_torch::sgb_contract_pool_prepared`` (registered when this module
is imported), whose CUDA implementation is the launch and the one place
that counts it, whose CPU implementation is the plain version, and whose
fake implementation gives ``torch.export`` the output's shape. The
kernel's design and bound are in the source's header.
"""

from __future__ import annotations

import numpy as np
import torch

from stofnet_tpu_torch.ops.kernels import _build
from stofnet_tpu_torch.ops.kernels.sgb import (
    CHANNELS, DMA_SIGNATURE, KSIZE, POOL, check_aligned, check_image_inputs,
    dma_weights_plain, sgb_contract_pool_reference, sgb_dma_weights,
)

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)
COUNTERS = ("launches",)


def dma_supported(length: int, channels: int) -> bool:
    """The shapes the serving kernel takes: L % 80 == 0, L >= 80 and
    C == 64. A documented departure from the JAX kernel's rule (L % 800 ==
    0, L >= 800), which picks a TPU tiling of 800-sample chunks, not a
    function: the two agree wherever L % 800 == 0, and the card's kernel
    walks tiles of two windows with a masked last tile, so every
    L % 80 == 0 is the same function."""
    return length % POOL == 0 and length >= POOL and channels == CHANNELS


def spike_inputs(batch: int, length: int, seed: int = 0):
    """Inputs on which a tap that reads one row off changes the output,
    where random inputs hide it under the max over 80 rows: numpy f32 h
    (B, L, 64), w (5, 64, 512) and b (512,), every value a small integer,
    so every f32 sum is exact and any order of sums gives the same bits.
    Output channel f reads one tap (f % 5) of one input channel
    ((f // 5) % 64) with weight 1 + f % 3, bias f % 2. h is zero but for
    spikes of heights 1..8: in about half the windows of each channel, one
    at window offset 0, 1, 78 or 79 (where the halo of a neighbouring
    window reads it), and at the two rows of each sequence end."""
    rng = np.random.default_rng(seed)
    f = np.arange(8 * CHANNELS)
    w = np.zeros((KSIZE, CHANNELS, f.size), np.float32)
    w[f % KSIZE, (f // KSIZE) % CHANNELS, f] = 1 + f % 3
    b = (f % 2).astype(np.float32)
    windows = length // POOL
    offsets = np.array([0, 1, POOL - 2, POOL - 1])
    pos = (np.arange(windows)[None, :, None] * POOL
           + offsets[rng.integers(0, 4, (batch, windows, CHANNELS))])
    bi, wi, ci = np.nonzero(rng.random((batch, windows, CHANNELS)) < 0.5)
    h = np.zeros((batch, length, CHANNELS), np.float32)
    h[bi, pos[bi, wi, ci], ci] = rng.integers(1, 9, bi.size)
    h[:, [0, 1, length - 2, length - 1]] = rng.integers(
        1, 9, (batch, 4, CHANNELS))
    return h, w, b


def sgb_contract_pool_dma_reference(h: torch.Tensor, w: torch.Tensor,
                                    b: torch.Tensor,
                                    negative_slope: float = 0.01
                                    ) -> torch.Tensor:
    """Plain version at the kernel's rounding points (weights and bias
    rounded to ``h.dtype``, f32 sums, max, leaky, one rounding to
    ``h.dtype``). It keeps this name so that each kernel module pairs its
    wrapper with a ``*_reference`` of its own, as the others do; the
    function is ``sgb.sgb_contract_pool_reference``."""
    return sgb_contract_pool_reference(h, w, b, negative_slope)


def sgb_contract_pool_dma(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          negative_slope: float = 0.01) -> torch.Tensor:
    """leaky(maxpool80(conv1d_same(h, w) + b)): :func:`sgb_dma_weights` on
    ``h``'s device, then :func:`sgb_contract_pool_dma_prepared`.

    Args:
        h: (B, L, 64) features with :func:`dma_supported`; bfloat16 on a
            CUDA device.
        w: (5, 64, F) conv weights (flax layout), F % 128 == 0 on CUDA.
        b: (F,) bias.
    Returns: (B, L // 80, F) in ``h.dtype``.
    """
    image, bias = sgb_dma_weights(w.to(h.device), b.to(h.device), h.dtype)
    return sgb_contract_pool_dma_prepared(h, image, bias, negative_slope)


def sgb_contract_pool_dma_prepared(h: torch.Tensor, image: torch.Tensor,
                                   bias: torch.Tensor,
                                   negative_slope: float = 0.01
                                   ) -> torch.Tensor:
    """:func:`sgb_contract_pool_dma` on weights in the
    :func:`sgb_dma_weights` image, through the custom op
    ``stofnet_torch::sgb_contract_pool_prepared``: the CUDA kernel on a
    CUDA tensor, the plain version on a CPU tensor. Raises ValueError on a
    shape :func:`dma_supported` refuses. The one launch path of the
    serving instantiation."""
    return torch.ops.stofnet_torch.sgb_contract_pool_prepared(
        h, image, bias, float(negative_slope))


def _check(h: torch.Tensor, image: torch.Tensor, bias: torch.Tensor) -> None:
    """The op's shape, type and device checks, storage not read (a fake
    tensor of a traced program is checked as a real one)."""
    _, length, c = h.shape
    if not dma_supported(length, c):
        raise ValueError(f"sgb_contract_pool_dma: h {tuple(h.shape)}: "
                         f"needs L % 80 == 0, L >= 80 and C == 64")
    check_image_inputs("sgb_contract_pool_dma", h, image, bias)


# The serving kernel as a custom op, so that torch.export traces it (a fake
# tensor has no storage for the ctypes launch) and a saved program names
# it. Registering builds nothing: nvcc runs at the first launch.
@torch.library.custom_op("stofnet_torch::sgb_contract_pool_prepared",
                         mutates_args=(), device_types="cpu")
def _sgb_op(h: torch.Tensor, image: torch.Tensor, bias: torch.Tensor,
            negative_slope: float) -> torch.Tensor:
    """The CPU implementation: the plain version on the image's weights,
    laid out as the kernel's output (contiguous)."""
    _check(h, image, bias)
    return sgb_contract_pool_dma_reference(h, dma_weights_plain(image),
                                           bias, negative_slope).contiguous()


@_sgb_op.register_kernel("cuda")
def _sgb_cuda(h: torch.Tensor, image: torch.Tensor, bias: torch.Tensor,
              negative_slope: float) -> torch.Tensor:
    """The CUDA implementation: the kernel's launch, which counts."""
    global launches
    _check(h, image, bias)
    check_aligned("sgb_contract_pool_dma", h)
    bsz, length, _ = h.shape
    f = bias.shape[0]
    h, image, bias = h.contiguous(), image.contiguous(), bias.contiguous()
    out = torch.empty((bsz, length // POOL, f), dtype=torch.bfloat16,
                      device=h.device)
    lib = _build.load("sgb_contract_pool_dma", DMA_SIGNATURE)
    err = lib.sgb_contract_pool_dma_launch(
        h.data_ptr(), image.data_ptr(), bias.data_ptr(), out.data_ptr(), bsz,
        length, f, float(negative_slope), *_build.launch_args(h))
    _build.check(lib, err, "sgb_contract_pool_dma")
    launches += 1
    return out


@_sgb_op.register_fake
def _sgb_fake(h: torch.Tensor, image: torch.Tensor, bias: torch.Tensor,
              negative_slope: float) -> torch.Tensor:
    """The shape of the output, after the same checks, so that a program
    the kernel would refuse fails at export."""
    _check(h, image, bias)
    bsz, length, _ = h.shape
    return h.new_empty((bsz, length // POOL, bias.shape[0]))
