"""SemiGlobalBlock contract path with the input streamed through a copy ring:
conv1d(k5, 64->F) + 80x max-pool + leaky (replaces
``stofnet_tpu/ops/pallas/sgb_dma_kernel.py:sgb_contract_pool_dma``).

The same function as ``sgb.sgb_contract_pool``, for the shapes of
:func:`dma_supported`. ``sgb_contract_pool_dma`` launches the CUDA kernel
``csrc/sgb_contract_pool_dma.cu`` on a CUDA tensor and runs
``sgb_contract_pool_dma_reference`` on a CPU tensor. A server lays the
weights out once with ``sgb.sgb_weights`` (the layout both SGB kernels
take) and calls ``sgb_contract_pool_dma_prepared`` per batch. The kernel's
design and bound are in the source's header.
"""

from __future__ import annotations

import ctypes

import torch

from stofnet_tpu_torch.ops.kernels import _build
from stofnet_tpu_torch.ops.kernels.sgb import (
    CHANNELS, KSIZE, N_TILE, POOL, sgb_contract_pool_reference, sgb_weights,
)

CHUNK = 800  # samples: the JAX kernel's chunk, 10 pool windows

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)
COUNTERS = ("launches",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURE = {"sgb_contract_pool_dma_launch": [_P, _P, _P, _P, _I, _I, _I,
                                               ctypes.c_float, _I, _P]}


def dma_supported(length: int, channels: int) -> bool:
    """The shapes the streamed kernel takes, as the JAX kernel's rule:
    L % 800 == 0, L >= 800 and C == 64. The dispatch rule of
    ``models/fused.py``'s ``sgb_impl="dma"``."""
    return length % CHUNK == 0 and length >= CHUNK and channels == CHANNELS


def sgb_contract_pool_dma_reference(h: torch.Tensor, w: torch.Tensor,
                                    b: torch.Tensor,
                                    negative_slope: float = 0.01
                                    ) -> torch.Tensor:
    """Plain version: the tile kernel's, at the same rounding points
    (weights and bias rounded to ``h.dtype``, f32 sums, max, leaky, one
    rounding to ``h.dtype``). It keeps this name so that each kernel module
    pairs its wrapper with a ``*_reference`` of its own, as the others do;
    the function is ``sgb.sgb_contract_pool_reference``."""
    return sgb_contract_pool_reference(h, w, b, negative_slope)


def sgb_contract_pool_dma(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          negative_slope: float = 0.01) -> torch.Tensor:
    """leaky(maxpool80(conv1d_same(h, w) + b)): ``sgb_weights`` on ``h``'s
    device, then :func:`sgb_contract_pool_dma_prepared`.

    Args:
        h: (B, L, 64) features with :func:`dma_supported`; bfloat16 on a
            CUDA device.
        w: (5, 64, F) conv weights (flax layout), F % 128 == 0 on CUDA.
        b: (F,) bias.
    Returns: (B, L // 80, F) in ``h.dtype``.
    """
    wt, bias = sgb_weights(w.to(h.device), b.to(h.device), h.dtype)
    return sgb_contract_pool_dma_prepared(h, wt, bias, negative_slope)


def sgb_contract_pool_dma_prepared(h: torch.Tensor, wt: torch.Tensor,
                                   bias: torch.Tensor,
                                   negative_slope: float = 0.01
                                   ) -> torch.Tensor:
    """:func:`sgb_contract_pool_dma` on weights in ``sgb_weights``' layout:
    the CUDA kernel on a CUDA tensor, the plain version on a CPU tensor.
    Raises ValueError on a shape :func:`dma_supported` refuses."""
    global launches
    bsz, length, c = h.shape
    f = wt.shape[0]
    if (not dma_supported(length, c) or wt.shape != (f, KSIZE * c)
            or bias.shape != (f,)):
        raise ValueError(f"sgb_contract_pool_dma: h {tuple(h.shape)}, "
                         f"weights {tuple(wt.shape)}, bias "
                         f"{tuple(bias.shape)}: needs L % 800 == 0, L >= 800, "
                         f"C == 64, weights (F, 5 * C) and bias (F,)")
    if h.device.type == "cpu":
        w = wt.reshape(f, KSIZE, c).permute(1, 2, 0)
        return sgb_contract_pool_dma_reference(h, w, bias, negative_slope)
    if (h.device.type != "cuda" or h.dtype != torch.bfloat16
            or wt.dtype != torch.bfloat16 or bias.dtype != torch.float32
            or not wt.device == bias.device == h.device):
        raise TypeError(f"sgb_contract_pool_dma: the CUDA kernel takes "
                        f"bfloat16 on a CUDA device, got {h.dtype} on "
                        f"{h.device} with weights {wt.dtype} on {wt.device}")
    if f % N_TILE:
        raise ValueError(f"sgb_contract_pool_dma: the CUDA kernel takes "
                         f"F % 128 == 0, got F={f}")
    h, wt, bias = h.contiguous(), wt.contiguous(), bias.contiguous()
    out = torch.empty((bsz, length // POOL, f), dtype=torch.bfloat16,
                      device=h.device)
    lib = _build.load("sgb_contract_pool_dma", _SIGNATURE)
    err = lib.sgb_contract_pool_dma_launch(
        h.data_ptr(), wt.data_ptr(), bias.data_ptr(), out.data_ptr(), bsz,
        length, f, float(negative_slope), h.device.index or 0,
        torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(lib, err, "sgb_contract_pool_dma")
    launches += 1
    return out
