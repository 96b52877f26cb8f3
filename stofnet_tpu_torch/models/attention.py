"""1-D self-attention block (replaces ``stofnet_tpu/models/attention.py``).

Scaled dot-product attention over the (possibly max-pooled) positions of
(B, L, C) features, added back to the input as a residual. Nothing in
either package calls it: it is the library module the JAX package ships,
with no registry name.

The weights are those of flax's ``MultiHeadDotProductAttention`` under the
scope ``sdpa``, in flax's layout: ``query``/``key``/``value`` kernels
(C, H, D) with (H, D) biases, the ``out`` kernel (H, D, C) with a (C,)
bias, D = C // H. :func:`state_from_flax` carries a flax tree across. A
fresh block draws them from flax's init distribution (LeCun normal,
truncated at two standard deviations; zero biases), not its bits.

The ``pool > 1`` path keeps JAX's order: a VALID max-pool drops the tail
when L % pool != 0, the repeat gives (L // pool) * pool rows, and the pad
puts ``pad // 2`` zero rows in front and the rest behind.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from stofnet_tpu_torch import DeviceLike, resolve_device

# flax's truncated normal at +-2 standard deviations has this standard
# deviation; variance_scaling divides it out
_TRUNC_STD = 0.87962566103423978


class _DenseGeneral(nn.Module):
    """A flax ``DenseGeneral`` kernel and bias, kept in flax's shapes."""

    def __init__(self, kernel_shape, bias_shape, fan_in: int):
        super().__init__()
        self.fan_in = fan_in
        self.kernel = nn.Parameter(torch.empty(kernel_shape))
        self.bias = nn.Parameter(torch.empty(bias_shape))


class _MultiHeadAttention(nn.Module):
    def __init__(self, features: int, num_heads: int):
        super().__init__()
        if features % num_heads:
            raise ValueError(f"features {features} is not a multiple of "
                             f"num_heads {num_heads}")
        h, d = num_heads, features // num_heads
        self.num_heads, self.head_dim = h, d
        for name in ("query", "key", "value"):
            self.add_module(name, _DenseGeneral((features, h, d), (h, d),
                                                features))
        self.out = _DenseGeneral((h, d, features), (features,), features)


class AttentionBlock1D(nn.Module):
    """Self-attention over the length axis of (B, L, C) features:
    ``x + attn(x)``, the attention softmax(QK^T / sqrt(D)) V in f32 (or
    ``dtype``) on every device.
    """

    def __init__(self, features: int, num_heads: int = 4, pool: int = 1,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.features, self.pool, self.dtype = features, int(pool), dtype
        with torch.device("meta"):
            self.sdpa = _MultiHeadAttention(features, num_heads)
        if device.type != "meta":
            self.to_empty(device="cpu")
            self.reset_parameters(generator)
            self.to(device)

    @torch.no_grad()
    def reset_parameters(self,
                         generator: Optional[torch.Generator] = None) -> None:
        """flax's init: LeCun normal kernels (truncated at 2 std), zero
        biases, drawn in module order from ``generator``."""
        for dense in (self.sdpa.query, self.sdpa.key, self.sdpa.value,
                      self.sdpa.out):
            std = 1.0 / math.sqrt(dense.fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(dense.kernel, std=std, a=-2 * std,
                                  b=2 * std, generator=generator)
            dense.bias.zero_()

    def _attend(self, h: torch.Tensor) -> torch.Tensor:
        m = self.sdpa
        dt = self.dtype

        def project(dense):
            k, b = dense.kernel, dense.bias
            x = h
            if dt is not None:
                x, k, b = x.to(dt), k.to(dt), b.to(dt)
            return torch.einsum("blc,chd->bhld", x, k) + b[None, :, None]

        q, k, v = project(m.query), project(m.key), project(m.value)
        w = torch.einsum("bhqd,bhkd->bhqk", q / math.sqrt(m.head_dim), k)
        y = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(w, dim=-1), v)
        kernel, bias = m.out.kernel, m.out.bias
        if dt is not None:
            kernel, bias = kernel.to(dt), bias.to(dt)
        return torch.einsum("bhld,hdc->blc", y, kernel) + bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        if self.pool > 1:
            h = F.max_pool1d(h.transpose(1, 2), self.pool,
                             self.pool).transpose(1, 2)
        y = self._attend(h)
        if self.pool > 1:
            y = torch.repeat_interleave(y, self.pool, dim=1)
            pad = max(0, x.shape[1] - y.shape[1])
            y = F.pad(y, (0, 0, pad // 2, pad - pad // 2))
        return x + y


def state_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The block's state dict from a flax ``AttentionBlock1D``'s variables
    (arrays numpy can read): ``params.sdpa.<dense>.{kernel,bias}`` ->
    ``sdpa.<dense>.{kernel,bias}``, shapes as they are."""
    sdpa = variables["params"]["sdpa"]
    return {f"sdpa.{dense}.{leaf}": torch.from_numpy(
        np.array(sdpa[dense][leaf], np.float32))
        for dense in ("query", "key", "value", "out")
        for leaf in ("kernel", "bias")}
