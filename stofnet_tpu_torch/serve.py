"""The RF->ToF serving pipeline (replaces the StofNet branch of
``stofnet_tpu/serve.py:make_pipeline``, ``probe_dtype_agreement`` and the
encoded-input helpers ``parse_input_enc``, ``make_input_encoder`` and
``_wrap_input_enc``).

``make_pipeline`` returns the serving callable ``x (B, 1, L) f32 -> coords``
with the weights closed over: the StofNet forward, through
``models/fused.py:fused_forward`` where that computes the module's function
(bf16 by default; on the card its two hot blocks run as CUDA kernels, on
weights laid out once per pipeline), through the int8-SGB forward
(``models/int8.py``) when it is given a calibration batch, and through the
``StofNet`` module elsewhere, then the protocol decode
``ops/peaks.mask2coords`` in the checkpoint's own upsample units.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from stofnet_tpu_torch import DeviceLike, resolve_device
from stofnet_tpu_torch.data.synthetic import gate_batch
from stofnet_tpu_torch.models.fused import FUSED_SCALES, fused_forward
from stofnet_tpu_torch.models.int8 import (
    QCONFIG, quantize_stofnet, stofnet_apply_int8,
)
from stofnet_tpu_torch.models.stofnet import StofNet
from stofnet_tpu_torch.ops.kernels.sgb import POOL
from stofnet_tpu_torch.ops.peaks import mask2coords
from stofnet_tpu_torch.serving.codecs import (
    chunk_len, encode_s8c, encode_s16, parse_s8c,
)

# the architecture arguments stofnet_apply_fused takes; the fused path has
# the default widths and kernel sizes
FUSED_OVERRIDES = ("upsample_factor", "num_blocks", "semi_global_scale")


def parse_input_enc(enc: Optional[str]) -> Tuple[str, int]:
    """``input_enc=`` spelling -> (kind, n_chunks). Kinds: ``"f32"``
    (default), ``"bf16"``, ``"s16"`` (alias ``int16``), ``"s8c"`` with an
    optional chunk count (``s8c16``; default ``serving/codecs.DEFAULT_CHUNKS``),
    the spellings the TCP wire takes, because they are the same schemes."""
    enc = "f32" if enc in (None, "") else str(enc)
    if enc in ("f32", "bf16"):
        return enc, 0
    if enc in ("s16", "int16"):
        return "s16", 0
    n = parse_s8c(enc)
    if n is not None:
        return "s8c", n
    raise ValueError(f"input_enc must be f32|bf16|s16|s8c<n>, got {enc!r}")


def make_input_encoder(enc: Optional[str]) -> Callable[[Any], tuple]:
    """The host-side encoder of ``make_pipeline(input_enc=enc)``:
    ``(B, 1, L) f32 -> the tuple of its inputs``. The codes are what the
    host copies to the card; the dequantization runs there."""
    kind, n = parse_input_enc(enc)
    if kind == "f32":
        return lambda x: (np.ascontiguousarray(x, np.float32),)
    if kind == "bf16":
        # round to nearest even, the cast the bf16 forward's first op does
        return lambda x: (torch.from_numpy(np.ascontiguousarray(
            x, np.float32)).to(torch.bfloat16),)
    if kind == "s16":
        def enc_s16(x):
            x = np.asarray(x, np.float32)
            codes, scales = encode_s16(x.reshape(x.shape[0], -1))
            return (codes.reshape(x.shape),
                    scales.reshape(-1, 1, 1).astype(np.float32))
        return enc_s16

    def enc_s8c(x):
        x = np.asarray(x, np.float32)
        codes, scales = encode_s8c(x.reshape(x.shape[0], -1), n)
        return (codes.reshape(x.shape),
                scales.reshape(x.shape[0], 1, n).astype(np.float32))
    return enc_s8c


def _wrap_input_enc(pipe: Callable, enc: Optional[str],
                    device: torch.device) -> Callable:
    """``pipe`` taking the encoded inputs of ``input_enc=enc``: the codes
    are copied to ``device`` and dequantized there (``codes * scale`` in
    f32, the numpy codecs' bits). f32 and bf16 inputs go to ``pipe`` as
    they are: its input cast absorbs a bf16 input."""
    kind, n = parse_input_enc(enc)
    if kind in ("f32", "bf16"):
        return pipe

    def dev(a) -> torch.Tensor:
        return torch.as_tensor(a).to(device)

    if kind == "s16":
        def pipe_enc(codes, scales):
            return pipe(dev(codes).to(torch.float32) * dev(scales))
    else:
        def pipe_enc(codes, scales):
            codes = dev(codes)
            b, _, length = codes.shape
            chunk_len(length, n)
            x = (codes.reshape(b, 1, n, length // n).to(torch.float32)
                 * dev(scales)[..., None]).reshape(b, 1, length)
            return pipe(x)
    pipe_enc.route, pipe_enc.calls = pipe.route, pipe.calls
    return pipe_enc


def make_pipeline(state: Mapping[str, Any], overrides: Dict[str, Any], *,
                  window_size: int = 20, threshold: Optional[float] = None,
                  max_echoes: int = 64, dtype: Optional[torch.dtype] = None,
                  device: DeviceLike = None, int8_calib: Any = None,
                  int8_stack_layers: Optional[Sequence[int]] = None,
                  int8_eq_alpha: Optional[float] = None,
                  int8_bias_correct: bool = False,
                  input_enc: Optional[str] = None) -> Callable:
    """The serving callable ``x (B, 1, L) f32 -> (B, max_echoes) coords``.

    Three routes, chosen when the pipeline is built and, between fused
    and module, by each call's L before its forward, never by catching an
    error:

    - **int8**, when ``int8_calib`` is given: ``stofnet_apply_int8`` on
      the state that ``quantize_stofnet`` calibrates on that
      representative (B, 1, L) batch, at every L. As in JAX, only the
      overrides of ``models/int8.QCONFIG`` pass on; the rest of the
      forward follows the weights' shapes. ``int8_stack_layers`` /
      ``int8_eq_alpha`` / ``int8_bias_correct`` also run the chosen stack
      convs in s8 (``quantize_stofnet``). Calibrate on echo-bearing data;
    - **fused**: ``fused_forward`` (the SGB and conv-stack kernels on the
      card, their plain versions on the CPU), where it computes the
      module's function (:func:`fused_takes`: no overrides beyond
      ``FUSED_OVERRIDES``, ``semi_global_scale`` 1 or 80, bfloat16 on a
      CUDA device) and L % 80 == 0 when there is a SemiGlobalBlock;
    - **module**: the ``StofNet(dtype=dtype, **overrides)`` module with
      the state loaded, everywhere else, as JAX's ``make_pipeline`` serves
      every checkpoint. It is built at the first call that needs it.

    ``pipe.route(length)`` names the route a length takes; ``pipe.calls``
    counts the calls served by each route the pipeline has (``int8``, or
    ``fused`` and ``module``).

    Args:
        state: StofNet state dict (reference torch names; tensors or numpy
            arrays), copied to ``device``.
        overrides: architecture as ``load_stofnet`` reports it.
        dtype: compute type of the forward, bfloat16 when None.
        device: ``cuda`` when None (raises without a card); ``"cpu"`` runs
            the plain versions of the kernels.
        input_enc: ``f32`` (None), ``bf16``, ``s16`` or ``s8c<n>``: the
            pipeline then takes the inputs ``make_input_encoder(input_enc)``
            makes, and dequantizes them on ``device``.
    """
    device = resolve_device(device)
    dtype = torch.bfloat16 if dtype is None else dtype
    up = int(overrides.get("upsample_factor", 4))
    scale = int(overrides.get("semi_global_scale", POOL))
    params = {k: _tensor(v).to(device) for k, v in state.items()}
    forward = int8 = None
    if int8_calib is not None:
        qkw = {k: int(v) for k, v in overrides.items() if k in QCONFIG}
        stack = (tuple(int(i) for i in int8_stack_layers)
                 if int8_stack_layers else None)
        q = quantize_stofnet(params, int8_calib, stack_layers=stack,
                             eq_alpha=int8_eq_alpha,
                             bias_correct=int8_bias_correct, **qkw)

        def int8(x):
            return stofnet_apply_int8(q, x, dtype=dtype, stack_layers=stack,
                                      **qkw)
    elif fused_takes(overrides, dtype, device):
        forward = fused_forward(params, dtype=dtype,
                                **{k: int(v) for k, v in overrides.items()})
    module = None  # the StofNet module, once a call needs it

    def route(length: int) -> str:
        if int8 is not None:
            return "int8"
        if forward is not None and (scale == 1 or length % POOL == 0):
            return "fused"
        return "module"

    @torch.inference_mode()
    def pipe(x) -> torch.Tensor:
        nonlocal module
        x = torch.as_tensor(x).to(device).to(torch.float32)
        r = route(x.shape[-1])
        pipe.calls[r] += 1
        if r == "int8":
            heat = int8(x)
        elif r == "fused":
            heat = forward(x)
        else:
            if module is None:
                module = _module(params, overrides, dtype, device)
            heat = module(x)
        return mask2coords(heat, window_size=window_size,
                           threshold=threshold, upsample_factor=up,
                           max_echoes=max_echoes)

    pipe.route = route
    pipe.calls = dict.fromkeys(("int8",) if int8 is not None
                               else ("fused", "module"), 0)
    return _wrap_input_enc(pipe, input_enc, device)


def fused_takes(overrides: Mapping[str, Any], dtype: torch.dtype,
                device: torch.device) -> bool:
    """Whether ``fused_forward`` computes the module's function for this
    architecture and compute type on ``device``: no overrides beyond
    ``FUSED_OVERRIDES``, a ``semi_global_scale`` of 1 or 80, and on a CUDA
    device bfloat16, the type its kernels take (the plain versions on the
    CPU take any)."""
    scale = int(overrides.get("semi_global_scale", POOL))
    return (set(overrides) <= set(FUSED_OVERRIDES) and scale in FUSED_SCALES
            and (device.type == "cpu" or dtype == torch.bfloat16))


def probe_dtype_agreement(state: Mapping[str, Any],
                          overrides: Dict[str, Any], *, length: int,
                          batch: int = 16, seed: int = 3008,
                          device: DeviceLike = None, window_size: int = 20,
                          threshold: Optional[float] = None,
                          max_echoes: int = 64, int8_calib: Any = None,
                          **int8_kwargs) -> float:
    """Fraction of coords of the bf16 forward on ``device`` that lie within
    1 sample of the f32 forward's on the CPU, over one echo-bearing gate
    batch: the export-time check that the model is safe to serve in bf16.

    Both legs run the ``StofNet`` module, which rounds where the JAX
    package's serving forward does (flax's points: after each conv and
    each bias add), so the fraction is the one the JAX probe returns for
    the same weights and batch. The served fused forward rounds once per
    layer instead; ``chip_smoke.py`` measures how far its decoded coords
    lie from the module's on the card. With ``int8_calib`` (and the other
    ``int8_*`` arguments of :func:`make_pipeline`) both legs run the int8
    route, as JAX's probe runs the pipeline it is asked about."""
    x = gate_batch(batch, length, np.random.default_rng(seed))
    decode = dict(window_size=window_size, threshold=threshold,
                  max_echoes=max_echoes)
    if int8_calib is not None:
        bf16, f32 = (make_pipeline(state, overrides, dtype=dt, device=dev,
                                   int8_calib=int8_calib, **int8_kwargs,
                                   **decode)(x).cpu().numpy()
                     for dt, dev in ((torch.bfloat16, device),
                                     (torch.float32, "cpu")))
    else:
        bf16 = module_coords(state, overrides, x, torch.bfloat16, device,
                             **decode)
        f32 = module_coords(state, overrides, x, torch.float32, "cpu",
                            **decode)
    return float(np.mean(np.abs(bf16 - f32) <= 1.0))


def module_coords(state: Mapping[str, Any], overrides: Dict[str, Any], x,
                  dtype: torch.dtype, device: DeviceLike = None, *,
                  window_size: int = 20, threshold: Optional[float] = None,
                  max_echoes: int = 64) -> np.ndarray:
    """One leg of :func:`probe_dtype_agreement`: the decoded coords of the
    ``StofNet(dtype=dtype, **overrides)`` module on ``x`` (B, 1, L), as a
    numpy array on the host."""
    model = _module(state, overrides, dtype, device)
    dev = next(model.parameters()).device
    with torch.inference_mode():
        heat = model(torch.as_tensor(x, dtype=torch.float32).to(dev))
        coords = mask2coords(heat, window_size, threshold,
                             int(overrides.get("upsample_factor", 4)),
                             max_echoes)
    return coords.cpu().numpy()


def _module(state: Mapping[str, Any], overrides: Dict[str, Any],
            dtype: torch.dtype, device: DeviceLike) -> StofNet:
    """``StofNet(dtype=dtype, **overrides)`` on ``device`` with ``state``
    loaded."""
    model = StofNet(dtype=dtype, device=device, **overrides)
    model.load_state_dict({k: _tensor(v) for k, v in state.items()})
    return model


def _tensor(v) -> torch.Tensor:
    """A state entry as a tensor (numpy arrays are copied)."""
    return v if isinstance(v, torch.Tensor) else torch.tensor(v)
