"""Symmetric int8 helpers of the quantized StofNet serving path (replaces
``stofnet_tpu/ops/int8.py``).

Quantization is symmetric (zero-point 0), so SAME zero padding is exact in
the quantized domain. The s8 x s8 -> s32 SAME conv runs as
``torch._int_mm``, the s8 counterpart of ``torch.matmul`` (int8 tensor
cores on the card, an integer GEMM on the CPU): JAX computes it as an XLA
integer conv outside any Pallas kernel, so no kernel of this port stands
for it. ``quantize_weight`` lays the (K, Cin, Cout) codes out once so
that the product's second operand is column-major (each output channel's
K * Cin codes contiguous), the layout cuBLAS's int8 GEMM takes as it is.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

INT8_MAX = 127.0


def absmax_scale(x: torch.Tensor, dim=None) -> torch.Tensor:
    """Symmetric scale s such that x/s spans ~[-127, 127].

    ``dim=None`` gives a per-tensor scalar; a tuple of dims reduces over
    them, keeping them (e.g. per-output-channel weight scales). An
    all-zero slice gets scale 1, so quantization is a no-op there.
    """
    m = x.abs().amax() if dim is None else x.abs().amax(dim=dim, keepdim=True)
    return torch.where(m > 0, m, torch.full_like(m, INT8_MAX)) / INT8_MAX


def quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest (half to even) symmetric int8 quantization."""
    return torch.round(x / scale).clamp_(-INT8_MAX, INT8_MAX).to(torch.int8)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel int8 weights of a (K, Cin, Cout) conv kernel.

    Returns ``(wq int8 (K, Cin, Cout), scale (1, 1, Cout) f32)``; ``wq`` is
    laid out so that ``wq.reshape(K * Cin, Cout)`` is a column-major view
    (see the module docstring).
    """
    w = w.to(torch.float32)
    scale = absmax_scale(w, dim=(0, 1))
    return _mm_layout(quantize(w, scale)), scale


def _mm_layout(wq: torch.Tensor) -> torch.Tensor:
    """The same codes, stored so that the (K * Cin, Cout) matrix and each
    tap's (Cin, Cout) matrix are column-major views."""
    k, cin, cout = wq.shape
    return wq.reshape(k * cin, cout).t().contiguous().t().view(k, cin, cout)


def conv1d_same_int8(xq: torch.Tensor, wq: torch.Tensor,
                     impl: str = "conv") -> torch.Tensor:
    """SAME 1-D convolution on int8 operands with int32 accumulation.

    (B, L, Cin) s8 x (K, Cin, Cout) s8 -> (B, L, Cout) s32, padded
    (K-1)//2 left and K//2 right. Two forms, exact and equal:

    - ``"conv"``: one product over an im2col of the padded input,
      (B * L, K * Cin) x (K * Cin, Cout);
    - ``"dots"``: K shifted (B * L, Cin) x (Cin, Cout) products summed in
      int32.
    """
    if impl not in ("conv", "dots"):
        raise ValueError(f"unknown int8 conv impl {impl!r}")
    k, cin, cout = wq.shape
    b, length, _ = xq.shape
    xp = F.pad(xq, (0, 0, (k - 1) // 2, k // 2))
    if impl == "conv":
        # at B=1 the reshape is a view whose rows overlap (stride Cin),
        # which torch._int_mm on the CPU misreads: copy
        cols = xp.unfold(1, k, 1).transpose(2, 3).reshape(
            b * length, k * cin).contiguous()
        acc = torch._int_mm(cols, wq.reshape(k * cin, cout))
    else:
        acc = None
        for t in range(k):
            part = torch._int_mm(xp[:, t:t + length].reshape(b * length, cin),
                                 wq[t])
            acc = part if acc is None else acc.add_(part)
    return acc.view(b, length, cout)
