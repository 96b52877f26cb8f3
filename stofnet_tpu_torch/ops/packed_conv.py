"""Position-packed 1-D convolution (replaces
``stofnet_tpu/ops/packed_conv.py``: ``pack_kernel``, ``conv1d_blocked``,
``conv1d_same_packed``).

P consecutive positions become one row ("space-to-depth" on the length
axis): with blocks ``X'[t] = concat(x[P t + r] for r < P)`` and
``Y'[t] = concat(y[P t + j] for j < P)``, the SAME conv
``y[n] = sum_d W[d] x[n + d - pad]`` is the block conv
``Y'[t] = sum_q Wp[q - q_min]^T X'[t + q]`` with
``Wp[qi][r * Cin + ci, j * Cout + co] = W[P q + r - j + pad][ci, co]``
(zero where the tap falls outside [0, K)). The zeros add exactly 0: the
math is the plain conv's, only the order of the sums differs. The JAX
package packs to fill the TPU's 128 output lanes; here it is plain
PyTorch (cuDNN), ported for parity and measured by ``chip_smoke.py``.
Layouts are the JAX package's: (B, L, C) activations, (K, Cin, Cout)
kernels.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from stofnet_tpu_torch.ops.conv import conv1d, conv1d_same


def pack_kernel(kernel: torch.Tensor, pack: int
                ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """The block-conv kernel for ``pack`` packed positions: (K, Cin, Cout)
    -> ((Kp, P * Cin, P * Cout), (pad_lo, pad_hi)), the padding in blocks."""
    k, cin, cout = kernel.shape
    pad = (k - 1) // 2
    p = int(pack)
    q_min = -((pad + p - 1) // p)  # floor(-pad / P)
    q_max = (p - 1 + k - 1 - pad) // p
    qs = np.arange(q_min, q_max + 1)
    # tap d = P q + r - j + pad for (block tap q, in-pos r, out-pos j)
    d = (p * qs[:, None, None] + np.arange(p)[None, :, None]
         - np.arange(p)[None, None, :] + pad)  # (Kp, P_r, P_j)
    dc = torch.from_numpy(np.where((d >= 0) & (d < k), d, k)).to(
        kernel.device)  # k: the zero row
    w_ext = torch.cat([kernel, kernel.new_zeros((1, cin, cout))])
    wp = w_ext[dc].permute(0, 1, 3, 2, 4)  # (Kp, P_r, Cin, P_j, Cout)
    return wp.reshape(len(qs), p * cin, p * cout), (-q_min, q_max)


def conv1d_blocked(xb: torch.Tensor, kernel: torch.Tensor,
                   bias: torch.Tensor, pack: int) -> torch.Tensor:
    """SAME conv in the blocked domain: (B, L/P, P * Cin) ->
    (B, L/P, P * Cout). A chain of blocked convs (and elementwise ops, which
    do not see the layout) never repacks between layers."""
    wp, padding = pack_kernel(kernel, pack)
    return conv1d(xb, wp, bias.repeat(int(pack)), padding)


def conv1d_same_packed(x: torch.Tensor, kernel: torch.Tensor,
                       bias: torch.Tensor, pack: int = 2) -> torch.Tensor:
    """SAME conv (B, L, Cin) -> (B, L, Cout), the plain conv's math,
    computed ``pack`` positions per row; the plain conv when L % pack or
    pack <= 1."""
    bsz, length, cin = x.shape
    p = int(pack)
    if p <= 1 or length % p:
        return conv1d_same(x, kernel, bias)
    y = conv1d_blocked(x.reshape(bsz, length // p, p * cin), kernel, bias, p)
    return y.reshape(bsz, length, kernel.shape[2])

