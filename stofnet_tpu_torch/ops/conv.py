"""Channels-last 1-D convolution (replaces ``conv1d_same`` of
``stofnet_tpu/ops/packed_conv.py``).

Tensors keep the JAX package's layout: activations (B, L, C), kernels
(K, Cin, Cout). With ``dtype`` the inputs, kernel and bias are cast first
and the conv output and the bias add each round to ``dtype``, as flax's
``nn.Conv(dtype=...)`` does.

On the card PyTorch lets cuDNN compute f32 convs in TF32 by default; the
f32 forwards that stand for JAX's full-f32 sums run under :func:`full_f32`.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Tuple

import torch
import torch.nn.functional as F


def conv1d(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
           padding: Tuple[int, int],
           dtype: Optional[torch.dtype] = None,
           stride: int = 1) -> torch.Tensor:
    """(B, L, Cin) x (K, Cin, Cout) + (Cout,) with explicit zero padding."""
    if dtype is not None:
        x, kernel, bias = x.to(dtype), kernel.to(dtype), bias.to(dtype)
    xt = F.pad(x.transpose(1, 2), padding)
    y = F.conv1d(xt, kernel.permute(2, 1, 0), stride=stride)
    return y.transpose(1, 2) + bias


def same(k: int) -> Tuple[int, int]:
    """flax ``padding='SAME'`` at stride 1: (k-1)//2 left, k//2 right."""
    return ((k - 1) // 2, k // 2)


def conv_layer(conv: torch.nn.Conv1d, x: torch.Tensor,
               padding: Tuple[int, int] = (0, 0),
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """An ``nn.Conv1d``'s parameters (and stride) on a (B, L, C) tensor:
    :func:`conv1d` with its rounding points. (0, 0) is flax's VALID."""
    return conv1d(x, conv.weight.permute(2, 1, 0), conv.bias, padding, dtype,
                  conv.stride[0])


def dense(linear: torch.nn.Linear, x: torch.Tensor,
          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """An ``nn.Linear``'s parameters as flax's ``nn.Dense(dtype=...)``
    applies them: the product and the bias add each round to ``dtype``."""
    w, b = linear.weight, linear.bias
    if dtype is not None:
        x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
    return torch.matmul(x, w.t()) + b


def conv1d_same(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """flax ``padding='SAME'``: pads (k-1)//2 left and k//2 right."""
    return conv1d(x, kernel, bias, same(kernel.shape[0]), dtype)


_f32_lock = threading.Lock()
_f32_depth = 0  # blocks of full_f32 open in any thread
_f32_saved: Tuple[bool, bool] = (True, False)


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    """cuDNN's convs and cuBLAS's matmuls in full f32 inside the block:
    ``torch.backends.cudnn.allow_tf32`` and
    ``torch.backends.cuda.matmul.allow_tf32`` False, the caller's values
    restored when the last open block closes. cuDNN's other settings
    (enabled, benchmark, deterministic) are left as they are; a bf16
    forward computes the same under it. The flags are process-wide: blocks
    open in several threads at once (a daemon's dispatcher threads, one a
    length) share one saved state under a lock, so the flags stay off
    until the last of them closes and then come back as the caller set
    them; another thread of the process sees them off meanwhile."""
    global _f32_depth, _f32_saved
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    with _f32_lock:
        if _f32_depth == 0:
            _f32_saved = cudnn.allow_tf32, matmul.allow_tf32
            cudnn.allow_tf32 = matmul.allow_tf32 = False
        _f32_depth += 1
    try:
        yield
    finally:
        with _f32_lock:
            _f32_depth -= 1
            if _f32_depth == 0:
                cudnn.allow_tf32, matmul.allow_tf32 = _f32_saved
