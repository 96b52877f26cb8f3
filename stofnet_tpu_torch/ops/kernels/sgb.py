"""Fused SemiGlobalBlock contract path: conv1d(k5, 64->F) + 80x max-pool +
leaky (replaces ``stofnet_tpu/ops/pallas/sgb_kernel.py:sgb_contract_pool``).

``sgb_contract_pool`` launches the CUDA kernel ``csrc/sgb_contract_pool.cu``
on a CUDA tensor and runs ``sgb_contract_pool_reference`` on a CPU tensor.
A server lays the weights out once (``sgb_weights``) and calls
``sgb_contract_pool_prepared`` per batch.
The kernel never allocates the (B, L, F) pre-pool tensor: only the pooled
(B, L/80, F) rows reach device memory. Its design and its bound are in the
source's header.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from stofnet_tpu_torch.ops.conv import conv1d_same
from stofnet_tpu_torch.ops.kernels import _build

POOL = 80
KSIZE = 5
CHANNELS = 64
N_TILE = 128  # output channels per CTA (csrc/sgb_contract_pool.cu)

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)

_P = ctypes.c_void_p
_SIGNATURE = {"sgb_contract_pool_launch": [
    _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
    ctypes.c_int, _P]}


def sgb_contract_pool_reference(h: torch.Tensor, w: torch.Tensor,
                                b: torch.Tensor,
                                negative_slope: float = 0.01) -> torch.Tensor:
    """Plain version at the kernel's rounding points: weights and bias
    rounded to ``h.dtype``, the conv in f32, max-pool, leaky, then one
    rounding to ``h.dtype``."""
    dt = h.dtype
    y = conv1d_same(h.float(), w.to(dt).float(), b.to(dt).float())
    y = F.max_pool1d(y.transpose(1, 2), POOL)  # (B, F, L/80)
    return F.leaky_relu(y, negative_slope).transpose(1, 2).to(dt)


def sgb_weights(w: torch.Tensor, b: torch.Tensor, dtype: torch.dtype):
    """The kernel's layout of the contract conv, built once per model: w
    (5, C, F) -> (F, 5 * C) as [n][t * C + c] in ``dtype``, and b rounded
    to ``dtype`` and held in f32."""
    k, c, f = w.shape
    if k != KSIZE or b.shape != (f,):
        raise ValueError(f"sgb_weights: w {tuple(w.shape)}, b "
                         f"{tuple(b.shape)}: needs w (5, C, F) and b (F,)")
    wt = w.to(dtype).permute(2, 0, 1).reshape(f, k * c).contiguous()
    return wt, b.to(dtype).float().contiguous()


def sgb_contract_pool(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      negative_slope: float = 0.01) -> torch.Tensor:
    """leaky(maxpool80(conv1d_same(h, w) + b)): :func:`sgb_weights` on
    ``h``'s device, then :func:`sgb_contract_pool_prepared`.

    Args:
        h: (B, L, 64) features, L % 80 == 0; bfloat16 on a CUDA device.
        w: (5, 64, F) conv weights (flax layout), F % 128 == 0 on CUDA.
        b: (F,) bias.
    Returns: (B, L // 80, F) in ``h.dtype``.
    """
    wt, bias = sgb_weights(w.to(h.device), b.to(h.device), h.dtype)
    return sgb_contract_pool_prepared(h, wt, bias, negative_slope)


def sgb_contract_pool_prepared(h: torch.Tensor, wt: torch.Tensor,
                               bias: torch.Tensor,
                               negative_slope: float = 0.01) -> torch.Tensor:
    """:func:`sgb_contract_pool` on weights already in the kernel's layout
    (:func:`sgb_weights`): the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    global launches
    bsz, length, c = h.shape
    f = wt.shape[0]
    if wt.shape != (f, KSIZE * c) or bias.shape != (f,) or length % POOL:
        raise ValueError(f"sgb_contract_pool: h {tuple(h.shape)}, weights "
                         f"{tuple(wt.shape)}, bias {tuple(bias.shape)}: needs "
                         f"weights (F, 5 * C), bias (F,) and L % 80 == 0")
    if h.device.type == "cpu":
        w = wt.reshape(f, KSIZE, c).permute(1, 2, 0)
        return sgb_contract_pool_reference(h, w, bias, negative_slope)
    if (h.device.type != "cuda" or h.dtype != torch.bfloat16
            or wt.dtype != torch.bfloat16 or bias.dtype != torch.float32
            or not wt.device == bias.device == h.device):
        raise TypeError("sgb_contract_pool: the CUDA kernel takes bfloat16 "
                        f"on a CUDA device, got {h.dtype} on {h.device} "
                        f"with weights {wt.dtype} on {wt.device}")
    if c != CHANNELS or f % N_TILE:
        raise ValueError(f"sgb_contract_pool: the CUDA kernel takes C == 64 "
                         f"and F % 128 == 0, got C={c}, F={f}")
    h, wt, bias = h.contiguous(), wt.contiguous(), bias.contiguous()
    out = torch.empty((bsz, length // POOL, f), dtype=torch.bfloat16,
                      device=h.device)
    lib = _build.load("sgb_contract_pool", _SIGNATURE)
    err = lib.sgb_contract_pool_launch(
        h.data_ptr(), wt.data_ptr(), bias.data_ptr(), out.data_ptr(), bsz,
        length, f, float(negative_slope), h.device.index or 0,
        torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(lib, err, "sgb_contract_pool")
    launches += 1
    return out
