"""What every model's plain reference and ``bench_port/check.py`` share:
the judgement of served positions against a reference heatmap, the
control's answers and its fp8 rounding, and f32 without TF32. Plain
PyTorch; it imports nothing of the program.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Optional

import torch

FP8_MAX = 448.0  # largest finite float8_e4m3fn

# rounds a conv's input and weight before the f32 product (the control)
Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    """cuDNN's convs and cuBLAS's products in full f32 inside the block."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale that maps its largest
    magnitude to the format's largest value, back in f32."""
    scale = t.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def served_gaps(ref: torch.Tensor, coords: torch.Tensor,
                upsample_factor: int) -> torch.Tensor:
    """Each row's widest gap by which a served position's reference value
    lies below the reference row's maximum, in units of the row's standard
    deviation: 0 where every served position is the reference's best.

    ``coords`` (n, E) are the decode's positions divided by the upsample
    factor, ascending, 0 for an empty slot. With a threshold of None the
    decode serves each row's maximum: a row with no position served
    answers position 0 (the decode cannot tell the two apart), and a
    position that is not finite or lies outside the row is infinitely
    wrong."""
    n, width = ref.shape
    coords = coords.to(ref.device, torch.float32)
    pos = coords * upsample_factor
    finite = torch.isfinite(pos).all(dim=1)
    idx = torch.round(torch.nan_to_num(pos)).long()
    inside = ((idx >= 0) & (idx < width)).all(dim=1) & finite
    served = coords != 0
    served[:, 0] |= ~served.any(dim=1)  # an empty row answers position 0
    idx = torch.where(served, idx.clamp(0, width - 1), 0)
    vals = torch.gather(ref, 1, idx)
    worst = torch.where(served, vals, torch.full_like(vals, float("inf")))
    gap = (ref.amax(dim=1) - worst.amin(dim=1)) / ref.std(dim=1)
    return torch.where(inside, gap, torch.full_like(gap, float("inf")))


def argmax_coords(ref: torch.Tensor, upsample_factor: int,
                  slots: int) -> torch.Tensor:
    """What a decode with a threshold of None serves from ``ref``: each
    row's first maximum, in samples, in slot 0 (the control's answers)."""
    out = torch.zeros((ref.shape[0], slots), device=ref.device)
    out[:, 0] = ref.argmax(dim=1).float() / upsample_factor
    return out
