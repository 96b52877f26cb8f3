"""The bench's compute paths (replaces ``bench.py:make_decoder``,
``make_xla_pipeline``, ``try_packed_pipeline``, ``try_fused_pipeline`` and
``try_int8_pipeline``).

Each path is a callable ``pipe(state, x) -> coords``: the StofNet forward
of one design over a state dict (reference torch names, on ``x``'s device)
and the bench's decode. ``try_packed_pipeline`` and ``try_fused_pipeline``
run their path once on a gate batch and return it only when at least 0.99
of its coord slots lie within 1 sample of ``coords_ref`` (the bench's
gate); otherwise ``None``. A build or launch failure raises: the gate
judges coords, nothing else.

- fused: ``stofnet_apply_fused(dtype=bf16, fused_stack=False)``, the
  streamed SGB kernel (at every L % 80 == 0, whatever ``sgb_impl`` the
  bench names) and the conv stack as plain convs, as the bench composes
  it.
- packed: ``stofnet_apply_packed(dtype=bf16, pack=2)``, plain PyTorch.
- int8: ``stofnet_apply_int8(dtype=bf16)`` on the state ``quantize_stofnet``
  calibrates on the gate batch: the SGB's contract conv as an s8 product
  (``torch._int_mm``), its pre-pool tensor requantized to s8.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from stofnet_tpu_torch import DeviceLike, resolve_device
from stofnet_tpu_torch.models.fused import (
    stofnet_apply_fused, stofnet_apply_packed,
)
from stofnet_tpu_torch.models.int8 import (
    quantize_stofnet, stofnet_apply_int8,
)
from stofnet_tpu_torch.models.stofnet import StofNet
from stofnet_tpu_torch.ops.peaks import mask2coords
from stofnet_tpu_torch.serve import FUSED_OVERRIDES

AGREE_MIN = 0.99  # the bench's gate: share of coord slots within 1 sample

Pipe = Callable[[Mapping[str, torch.Tensor], torch.Tensor], torch.Tensor]


def make_decoder(overrides: Dict[str, Any]
                 ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The heatmap -> coords decode of every path: window 20, threshold
    None, 8 echoes, in the checkpoint's own upsample units."""
    up = int(overrides.get("upsample_factor", 4))

    def decode(heat: torch.Tensor) -> torch.Tensor:
        return mask2coords(heat, window_size=20, threshold=None,
                           upsample_factor=up, max_echoes=8)
    return decode


def make_xla_pipeline(overrides: Dict[str, Any], dtype: Optional[torch.dtype],
                      device: DeviceLike = None) -> Pipe:
    """The bench's reference path: the ``StofNet(dtype=dtype, **overrides)``
    module over the state, then the decode. "xla" names the JAX path it
    replaces (the flax module compiled by XLA); here the module runs
    eagerly in PyTorch on ``device`` (``cuda`` when None)."""
    model = StofNet(dtype=dtype, device=resolve_device(device), **overrides)
    decode = make_decoder(overrides)

    @torch.inference_mode()
    def rf_to_tof(state: Mapping[str, torch.Tensor],
                  x: torch.Tensor) -> torch.Tensor:
        return decode(torch.func.functional_call(model, dict(state), (x,)))
    return rf_to_tof


def coord_agreement(coords: torch.Tensor, coords_ref) -> float:
    """Share of the coord slots within 1 sample of ``coords_ref`` (a tensor
    or an array)."""
    ref = (coords_ref.cpu() if isinstance(coords_ref, torch.Tensor)
           else torch.from_numpy(np.array(coords_ref, np.float32)))
    return float(((coords.float().cpu() - ref.float()).abs() <= 1.0)
                 .float().mean())


def try_packed_pipeline(state: Mapping[str, torch.Tensor],
                        overrides: Dict[str, Any], x: torch.Tensor,
                        coords_ref) -> Optional[Pipe]:
    """The position-packed path (``stofnet_apply_packed``, pack 2, bf16),
    gated on ``coords_ref`` over the batch ``x``."""
    kw = _fused_kwargs(overrides)
    decode = make_decoder(overrides)

    @torch.inference_mode()
    def pipe(state: Mapping[str, torch.Tensor],
             xb: torch.Tensor) -> torch.Tensor:
        return decode(stofnet_apply_packed(state, xb, dtype=torch.bfloat16,
                                           pack=2, **kw))
    return _gate(pipe, state, x, coords_ref)


def try_fused_pipeline(state: Mapping[str, torch.Tensor],
                       overrides: Dict[str, Any], x: torch.Tensor,
                       coords_ref) -> Optional[Pipe]:
    """The fused path: the streamed SGB kernel and the conv stack as plain
    convs, bf16, gated on ``coords_ref`` over the batch ``x``."""
    kw = _fused_kwargs(overrides)
    decode = make_decoder(overrides)

    @torch.inference_mode()
    def pipe(state: Mapping[str, torch.Tensor],
             xb: torch.Tensor) -> torch.Tensor:
        return decode(stofnet_apply_fused(state, xb, dtype=torch.bfloat16,
                                          fused_stack=False, **kw))
    return _gate(pipe, state, x, coords_ref)


def try_int8_pipeline(state: Mapping[str, torch.Tensor],
                      overrides: Dict[str, Any], x: torch.Tensor,
                      coords_ref) -> Optional[Pipe]:
    """The int8-SGB path, calibrated on the gate batch ``x`` and gated on
    ``coords_ref`` over it. The s8 conv's ``"conv"`` form (one product
    over an im2col) first; where the backend refuses that product
    (``RuntimeError``, as JAX's bench falls back when the backend rejects
    an integer conv), the ``"dots"`` form (K shifted products). The gate's
    verdict does not depend on the form, so a refused gate ends the try.
    The returned pipe names its form in ``pipe.impl``."""
    kw = _fused_kwargs(overrides)
    decode = make_decoder(overrides)
    q = quantize_stofnet(state, x, **kw)

    def make_pipe(impl: str) -> Pipe:
        @torch.inference_mode()
        def pipe(state: Mapping[str, torch.Tensor],
                 xb: torch.Tensor) -> torch.Tensor:
            return decode(stofnet_apply_int8(
                q, xb, dtype=torch.bfloat16, impl=impl, **kw))
        pipe.impl = impl
        return pipe

    try:
        return _gate(make_pipe("conv"), state, x, coords_ref)
    except RuntimeError:
        return _gate(make_pipe("dots"), state, x, coords_ref)


def _gate(pipe: Pipe, state, x, coords_ref) -> Optional[Pipe]:
    return pipe if coord_agreement(pipe(state, x),
                                   coords_ref) >= AGREE_MIN else None


def _fused_kwargs(overrides: Dict[str, Any]) -> Dict[str, int]:
    unsupported = set(overrides) - set(FUSED_OVERRIDES)
    if unsupported:
        raise ValueError(f"the fused and packed StofNet forwards take only "
                         f"{FUSED_OVERRIDES}, got {sorted(unsupported)}")
    return {k: int(v) for k, v in overrides.items()}
