"""The RF->ToF serving pipeline (replaces the StofNet branch of
``stofnet_tpu/serve.py:make_pipeline`` and ``probe_dtype_agreement``).

``make_pipeline`` returns the serving callable ``x (B, 1, L) f32 -> coords``
with the weights closed over: the StofNet forward through
``models/fused.py:stofnet_apply_fused`` (bf16 by default; on the card its
two hot blocks run as CUDA kernels, on weights laid out once per pipeline)
and the protocol decode
``ops/peaks.mask2coords`` in the checkpoint's own upsample units.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from stofnet_tpu_torch import DeviceLike, resolve_device
from stofnet_tpu_torch.data.synthetic import gate_batch
from stofnet_tpu_torch.models.fused import fused_forward
from stofnet_tpu_torch.models.stofnet import StofNet
from stofnet_tpu_torch.ops.peaks import mask2coords

# the architecture arguments stofnet_apply_fused takes; the fused path has
# the default widths and kernel sizes
FUSED_OVERRIDES = ("upsample_factor", "num_blocks", "semi_global_scale")


def make_pipeline(state: Mapping[str, Any], overrides: Dict[str, Any], *,
                  window_size: int = 20, threshold: Optional[float] = None,
                  max_echoes: int = 64, dtype: Optional[torch.dtype] = None,
                  device: DeviceLike = None
                  ) -> Callable[[Any], torch.Tensor]:
    """The serving callable ``x (B, 1, L) f32 -> (B, max_echoes) coords``.

    Args:
        state: StofNet state dict (reference torch names; tensors or numpy
            arrays), copied to ``device``.
        overrides: architecture as ``load_stofnet`` reports it; only
            ``upsample_factor``, ``num_blocks`` and ``semi_global_scale``
            may differ from the defaults.
        dtype: compute type of the forward, bfloat16 when None.
        device: ``cuda`` when None (raises without a card); ``"cpu"`` runs
            the plain versions of the kernels.
    """
    device = resolve_device(device)
    dtype = torch.bfloat16 if dtype is None else dtype
    unsupported = set(overrides) - set(FUSED_OVERRIDES)
    if unsupported:
        raise ValueError(f"the fused StofNet forward takes only "
                         f"{FUSED_OVERRIDES}, got {sorted(unsupported)}")
    kw = {k: int(v) for k, v in overrides.items()}
    up = kw.get("upsample_factor", 4)
    params = {k: _tensor(v).to(device) for k, v in state.items()}
    forward = fused_forward(params, dtype=dtype, **kw)

    @torch.inference_mode()
    def pipe(x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32).to(device)
        return mask2coords(forward(x), window_size=window_size,
                           threshold=threshold, upsample_factor=up,
                           max_echoes=max_echoes)

    return pipe


def probe_dtype_agreement(state: Mapping[str, Any],
                          overrides: Dict[str, Any], *, length: int,
                          batch: int = 16, seed: int = 3008,
                          device: DeviceLike = None, window_size: int = 20,
                          threshold: Optional[float] = None,
                          max_echoes: int = 64) -> float:
    """Fraction of coords of the bf16 forward on ``device`` that lie within
    1 sample of the f32 forward's on the CPU, over one echo-bearing gate
    batch: the export-time check that the model is safe to serve in bf16.

    Both legs run the ``StofNet`` module, which rounds where the JAX
    package's serving forward does (flax's points: after each conv and
    each bias add), so the fraction is the one the JAX probe returns for
    the same weights and batch. The served fused forward rounds once per
    layer instead; ``chip_smoke.py`` measures how far its decoded coords
    lie from the module's on the card."""
    x = gate_batch(batch, length, np.random.default_rng(seed))
    decode = dict(window_size=window_size, threshold=threshold,
                  max_echoes=max_echoes)
    bf16 = module_coords(state, overrides, x, torch.bfloat16, device,
                         **decode)
    f32 = module_coords(state, overrides, x, torch.float32, "cpu", **decode)
    return float(np.mean(np.abs(bf16 - f32) <= 1.0))


def module_coords(state: Mapping[str, Any], overrides: Dict[str, Any], x,
                  dtype: torch.dtype, device: DeviceLike = None, *,
                  window_size: int = 20, threshold: Optional[float] = None,
                  max_echoes: int = 64) -> np.ndarray:
    """One leg of :func:`probe_dtype_agreement`: the decoded coords of the
    ``StofNet(dtype=dtype, **overrides)`` module on ``x`` (B, 1, L), as a
    numpy array on the host."""
    model = StofNet(dtype=dtype, device=device, **overrides)
    model.load_state_dict({k: _tensor(v) for k, v in state.items()})
    dev = next(model.parameters()).device
    with torch.inference_mode():
        heat = model(torch.as_tensor(x, dtype=torch.float32).to(dev))
        coords = mask2coords(heat, window_size, threshold,
                             int(overrides.get("upsample_factor", 4)),
                             max_echoes)
    return coords.cpu().numpy()


def _tensor(v) -> torch.Tensor:
    """A state entry as a tensor (numpy arrays are copied)."""
    return v if isinstance(v, torch.Tensor) else torch.tensor(v)
