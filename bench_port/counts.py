"""Operations and bytes of the port's kernels, and the card's published
peaks: the yardstick the roofline and mfu readers divide by (a model's
operations a waveform are its model file's, ``reference/<model>.py``).
Plain arithmetic on shapes; imports nothing.

The counts are those of the kernel phase of ``chip_smoke.py`` (its
``bound``, ``sgb_bound`` and the conv stack's ``useful`` operations),
copied here so that a change to the program cannot move the yardstick:

- a conv of ``k`` taps from ``cin`` to ``cout`` channels over ``n``
  positions does ``2 n k cin cout`` operations (a multiply and an add);
- a kernel reads each input byte once and writes each output byte once;
- the least time of a kernel is the larger of its operations at the bf16
  peak and its bytes at the HBM peak.
"""

from __future__ import annotations

from typing import Tuple

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at the full
# 700 W power limit
PEAK_BF16 = 989e12  # FLOP/s, bf16 on the tensor cores
PEAK_HBM = 3.35e12  # B/s, HBM3

BF16, F32 = 2, 4  # bytes an element
POOL = 80  # the SemiGlobalBlock's pool: the SGB kernel pools a fixed 80


def conv_flops(positions: int, cin: int, cout: int, k: int) -> float:
    return 2.0 * positions * k * cin * cout


def least_s(flops: float, nbytes: float) -> Tuple[float, str]:
    """Least time in seconds at the bf16 and HBM peaks, and which sets it."""
    t_ops, t_bytes = flops / PEAK_BF16, nbytes / PEAK_HBM
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sgb_dma_call(batch: int, length: int, channels: int = 64,
                 features: int = 512, k: int = 5) -> Tuple[float, float]:
    """(operations, bytes) of one SGB kernel call: the contract conv over
    every position, bf16 features in, bf16 weights and f32 bias, the bf16
    pooled (B, L/80, F) out."""
    flops = conv_flops(batch * length, channels, features, k)
    nbytes = (batch * length * channels * BF16 + k * channels * features * BF16
              + features * F32 + batch * (length // POOL) * features * BF16)
    return flops, nbytes


def conv_stack_call(batch: int, length: int, channels: int = 64,
                    layers: int = 11, k: int = 7, r: int = 4,
                    k_last: int = 3) -> Tuple[float, float]:
    """(operations, bytes) of one conv-stack kernel call: conv2..conv12
    and conv_last on the kept positions, the bf16 (B, L, C) features and
    bf16 weights with f32 biases in, the f32 (B, L, r) heatmap out."""
    flops = (layers * conv_flops(batch * length, channels, channels, k)
             + conv_flops(batch * length, channels, r, k_last))
    nbytes = (batch * length * channels * BF16
              + layers * (k * channels * channels * BF16 + channels * F32)
              + k_last * channels * r * BF16 + r * F32
              + batch * length * r * F32)
    return flops, nbytes
