"""StofNet's forward and its served-coordinate judgement in plain PyTorch,
float32 without TF32: the reference that decides ``correct``.

Written from the published description (arXiv:2308.12009 and the
reference repository's ``stofnet.py``), on (B, C, L) tensors with
``torch.nn.functional`` convs; it imports nothing of the program.

    conv1 (k9, pad 4) + ReLU
    SemiGlobalBlock: contract conv (k5, SAME) + leaky 0.01, max-pool by
        the scale, expand conv (k5, SAME) + leaky 0.01, repeat by the
        scale, centred, added to the features
    conv2 .. conv{nb-2} (k7, SAME): leaky 0.01 after the even ones, a
        residual sum after the odd ones (conv3, conv5, ...)
    conv{nb-1} added to the SemiGlobalBlock's output (the global skip)
    conv_last (k3, pad 1) -> r channels, sample shuffle -> (B, L r)

``quant`` rounds each conv's input and weight before the f32 product: the
control computes the same forward in fp8 through it (:func:`fp8`).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Mapping, Optional

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8_e4m3fn
SLOPE = 0.01

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


def _conv(state: Mapping[str, torch.Tensor], h: torch.Tensor, name: str,
          pad: tuple, quant: Quant) -> torch.Tensor:
    w, b = state[f"{name}.weight"].float(), state[f"{name}.bias"].float()
    if quant is not None:
        h, w = quant(h), quant(w)
    return F.conv1d(F.pad(h, pad), w) + b[:, None]


def heatmap(state: Mapping[str, torch.Tensor], x: torch.Tensor,
            arch: Mapping, quant: Quant = None) -> torch.Tensor:
    """(B, 1, L) f32 frames -> (B, L r) f32 heatmap."""
    with no_tf32(), torch.no_grad():
        def conv(h, name, k):
            return _conv(state, h, name, ((k - 1) // 2, k // 2), quant)

        k1, km, kl = arch["kernel_sizes"]
        nb, r = arch["num_blocks"], arch["upsample_factor"]
        scale = arch["semi_global_scale"]
        h = F.relu(conv(x.float(), "conv1", k1))
        if scale != 1:
            s = F.leaky_relu(conv(h, "semi_global_block.contract_conv", 5),
                             SLOPE)
            s = F.max_pool1d(s, scale)
            s = F.leaky_relu(conv(s, "semi_global_block.expand_conv", 5),
                             SLOPE)
            s = torch.repeat_interleave(s, scale, dim=-1)
            pad = h.shape[-1] - s.shape[-1]
            h = h + F.pad(s, (pad // 2, pad // 2))
        res = res1 = h
        for i in range(2, nb - 1):
            y = conv(h, f"conv{i}", km)
            if i % 2:
                h = res = res + y
            else:
                h = F.leaky_relu(y, SLOPE)
        h = res1 + conv(h, f"conv{nb - 1}", km)
        h = conv(h, "conv_last", kl)  # (B, r, L)
        return h.transpose(1, 2).reshape(h.shape[0], -1)


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
