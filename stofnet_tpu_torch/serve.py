"""The RF->ToF serving pipeline (replaces ``stofnet_tpu/serve.py``'s
``make_pipeline``, ``probe_dtype_agreement`` and the encoded-input helpers
``parse_input_enc``, ``make_input_encoder`` and ``_wrap_input_enc``).

``make_pipeline`` returns the serving callable ``x (B, 1, L) f32 -> coords``
with the weights closed over: the StofNet forward, through
``models/fused.py:fused_forward`` where that computes the module's function
(bf16 by default; on the card its two hot blocks run as CUDA kernels, on
weights laid out once per pipeline), through the int8-SGB forward
(``models/int8.py``) when it is given a calibration batch, and through the
``StofNet`` module elsewhere, then the protocol decode
``ops/peaks.mask2coords`` in the checkpoint's own upsample units. With
``model_name=`` it serves any model of the registry (``models/registry``):
the zoo's module, then the same decode, or the regression families'
predictions as they are.

The exporter's half (replaces ``stofnet_tpu/serve.py:50-69,275-464``):
``export_pipeline`` traces that callable with ``torch.export`` into one
program per static length, the weights and the kernels' weight layouts
baked in (the two kernels are custom ops, ``ops/kernels``);
``export_pipeline_weightless`` takes the state dict as the program's
inputs instead; ``save_pipeline`` / ``load_pipeline`` write and serve the
file with no model code. Departure from JAX, whose artifacts are lowered
for ``platforms=("cpu", "tpu")``: a program serves on the device it was
exported for, because the device chooses the route (``fused_takes``: f32
on the card takes the module route, on the CPU the fused forward).

Every f32 route computes without TF32 (``ops/conv.full_f32``), as the JAX f32
pipeline sums in full f32, whatever the caller's flags.
"""

from __future__ import annotations

import contextlib
import copy
import functools
from pathlib import Path
from typing import (
    Any, Callable, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple,
    Union,
)

import numpy as np
import torch

from stofnet_tpu_torch import DeviceLike, resolve_device
from stofnet_tpu_torch.data.synthetic import gate_batch
from stofnet_tpu_torch.models.fused import FUSED_SCALES, fused_forward
from stofnet_tpu_torch.models import batchnorm
from stofnet_tpu_torch.models.int8 import (
    QCONFIG, quantize_stofnet, stofnet_apply_int8,
)
from stofnet_tpu_torch.models.registry import REGRESSION, build_model
from stofnet_tpu_torch.models.stofnet import StofNet
from stofnet_tpu_torch.ops.conv import full_f32
from stofnet_tpu_torch.ops.kernels.sgb import POOL
from stofnet_tpu_torch.ops.peaks import mask2coords
from stofnet_tpu_torch.parallel import seq
from stofnet_tpu_torch.serving.codecs import (
    chunk_len, encode_s8c, encode_s16, parse_s8c,
)

# the architecture arguments stofnet_apply_fused takes; the fused path has
# the default widths and kernel sizes
FUSED_OVERRIDES = ("upsample_factor", "num_blocks", "semi_global_scale")
# the example batch a batch-polymorphic export traces with: at least 2, so
# that the batch is not specialized to a constant
EXAMPLE_BATCH = 2


class TensorSpec(NamedTuple):
    """An input of an exported program: its shape, the batch an int or,
    in a batch-polymorphic program, the name of its symbol, and dtype."""
    shape: Tuple[Union[int, str], ...]
    dtype: torch.dtype


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
                  model_name: str = "stofnet",
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
    - **module**: the ``StofNet(dtype=dtype, **overrides)`` module on the
      state, everywhere else, as JAX's ``make_pipeline`` serves every
      checkpoint: a skeleton without data (:func:`_skeleton`), built with
      the pipeline, runs on the state through ``functional_call``, so that
      a traced pipeline builds no module inside the trace.

    An f32 pipeline runs its forward under ``full_f32`` (no TF32), on
    every device.

    ``pipe.route(length)`` names the route a length takes; ``pipe.calls``
    counts the calls served by each route the pipeline has (``int8``, or
    ``fused`` and ``module``). ``pipe.heatmap(x)`` is the forward alone,
    on the route of x's length and counted as a call, ``pipe.decode(heat)``
    the decode alone, and ``pipe.arch`` the forward's architecture:
    a length-sharded daemon (``cli/serve.py`` under ``mesh_sp``) runs the
    forward on each shard's window and decodes the joined rows.

    ``model_name`` other than ``stofnet`` serves that model of the
    registry through :func:`zoo_pipeline` (no int8, as in JAX).

    Args:
        state: the model's state dict (reference torch names; tensors or
            numpy arrays), copied to ``device``.
        overrides: StofNet's architecture as ``load_stofnet`` reports it;
            for the zoo, the ``registry.build_model`` arguments
            (``dataset_kind``, ``upsample_factor``, ``sample_num``,
            ``rf_scale_factor``, ``fs``).
        dtype: compute type of the forward, bfloat16 when None.
        device: ``cuda`` when None (raises without a card); ``"cpu"`` runs
            the plain versions of the kernels.
        input_enc: ``f32`` (None), ``bf16``, ``s16`` or ``s8c<n>``: the
            pipeline then takes the inputs ``make_input_encoder(input_enc)``
            makes, and dequantizes them on ``device``.
    """
    device = resolve_device(device)
    dtype = torch.bfloat16 if dtype is None else dtype
    if model_name.lower() != "stofnet":
        if int8_calib is not None or int8_stack_layers:
            raise ValueError("int8 serving targets model=stofnet only (the "
                             "quantized path is the SemiGlobalBlock; other "
                             "models have none)")
        pipe = zoo_pipeline(state, overrides, model_name, dtype=dtype,
                            device=device, window_size=window_size,
                            threshold=threshold, max_echoes=max_echoes)
        return _wrap_input_enc(pipe, input_enc, device)
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
    module = None
    if int8 is None:
        module, want = _skeleton(dtype, overrides)
        got = {k: tuple(v.shape) for k, v in params.items()}
        if want != got:
            raise ValueError(f"make_pipeline: the state does not fit "
                             f"StofNet(**{overrides}): "
                             f"{sorted(set(want.items()) ^ set(got.items()))}")
    precision = full_f32 if dtype == torch.float32 else contextlib.nullcontext

    def route(length: int) -> str:
        if int8 is not None:
            return "int8"
        if forward is not None and (scale == 1 or length % POOL == 0):
            return "fused"
        return "module"

    # counted through a dict of its own: a pipe that named itself would
    # be a reference cycle, its weights held on the card until a collection
    calls = dict.fromkeys(("int8",) if int8 is not None
                          else ("fused", "module"), 0)

    def heatmap(x) -> torch.Tensor:
        x = torch.as_tensor(x).to(device).to(torch.float32)
        r = route(x.shape[-1])
        calls[r] += 1
        # TF32's flags are process-wide: full_f32 holds them off while any
        # thread (a daemon's dispatcher of each length) is inside it
        with precision():
            if r == "int8":
                return int8(x)
            if r == "fused":
                return forward(x)
            return torch.func.functional_call(module, params, (x,))

    def decode(heat) -> torch.Tensor:
        return mask2coords(heat, window_size=window_size,
                           threshold=threshold, upsample_factor=up,
                           max_echoes=max_echoes)

    @torch.inference_mode()
    def pipe(x) -> torch.Tensor:
        return decode(heatmap(x))

    pipe.route, pipe.calls = route, calls
    pipe.heatmap = torch.inference_mode()(heatmap)
    pipe.decode = torch.inference_mode()(decode)
    pipe.arch = {"upsample_factor": up, "semi_global_scale": scale,
                 "num_blocks": int(overrides.get("num_blocks", 13))}
    return _wrap_input_enc(pipe, input_enc, device)


def zoo_pipeline(state: Mapping[str, Any], overrides: Dict[str, Any],
                 model_name: str, *, dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = None, window_size: int = 20,
                 threshold: Optional[float] = None,
                 max_echoes: int = 64) -> Callable:
    """The zoo branch of :func:`make_pipeline` (``stofnet_tpu/serve.py``
    187-213): the ``model_name`` module of ``registry.build_model(th=
    threshold, dtype=dtype, **overrides)`` in eval mode on its parameters
    and buffers ``state``, copied to ``device``. The module is a skeleton
    without data (:func:`_zoo_skeleton`; Kuleshov's dense head alone is
    1.2e9 weights at the chirp length) that runs on the state through
    ``functional_call``, so that a traced pipeline (the weightless export)
    builds no module inside the trace. Heatmap families decode with
    ``mask2coords`` at the registry's upsample factor (1 for sincnet and
    unet); zonzini and gradpeak return their predictions as (B, n) f32,
    gradpeak with ``max_echoes`` slots and its threshold the detector's.
    An f32 model, and gradpeak, which computes in f32 whatever the dtype,
    run under ``full_f32``. ``pipe.route`` and ``pipe.calls`` as the
    StofNet pipeline's, with the one route ``module``.

    A length-sharded daemon (``cli/serve.py`` under ``mesh_sp``) reads
    ``pipe.arch``, the family's rule (``parallel/seq.model_arch``), and
    ``pipe.decode(pred)``, the decode (or the regression's reshape) of
    the joined rows. A windowed family's replicas run ``pipe.heatmap(x,
    **kw)``, the forward alone on a shard's window (``kw``: the unet's
    ``shard``), as StofNet's do. Zonzini and Kuleshov join inside their
    forward (``parallel/seq.JOINED``): each replica of a dp row runs
    ``pipe.shard(x, shard)``, the forward as a ``parallel/seq.Shard``
    (its window, or Kuleshov's own samples; the joins through the shard's
    exchange), one thread each. ``functional_call`` swaps a module's
    tensors, so that form runs on a copy of the skeleton of its own,
    made at its first call (not inside a trace), and replicas run it on
    threads of their own."""
    device = resolve_device(device)
    name = model_name.lower()
    model, up, want = _zoo_skeleton(name, dtype, threshold, max_echoes,
                                    _arch_key(overrides))
    params = {k: _tensor(v).to(device) for k, v in state.items()}
    got = {k: tuple(v.shape) for k, v in params.items()}
    if want != got:
        raise ValueError(f"make_pipeline: the state does not fit "
                         f"{model_name}(**{overrides}): "
                         f"{sorted(set(want.items()) ^ set(got.items()))}")
    precision = (full_f32 if dtype == torch.float32 or name == "gradpeak"
                 else contextlib.nullcontext)

    calls = {"module": 0}  # not pipe's own attribute: no reference cycle

    def finish(pred) -> torch.Tensor:
        if name in REGRESSION:
            return pred.reshape(pred.shape[0], -1).to(torch.float32)
        return mask2coords(pred, window_size=window_size,
                           threshold=threshold, upsample_factor=up,
                           max_echoes=max_echoes)

    def forward(x, **kw) -> torch.Tensor:
        x = torch.as_tensor(x).to(device).to(torch.float32)
        calls["module"] += 1
        with precision():
            return torch.func.functional_call(model, params, (x,), kw)

    @torch.inference_mode()
    def pipe(x) -> torch.Tensor:
        return finish(forward(x))

    pipe.route, pipe.calls = (lambda length: "module"), calls
    pipe.arch, pipe.decode = seq.model_arch(model), torch.inference_mode()(
        finish)
    if pipe.arch["family"] not in seq.JOINED:
        pipe.heatmap = torch.inference_mode()(forward)
        return pipe
    arch, own = pipe.arch, []  # own: the shard form's skeleton

    @torch.inference_mode()
    def shard(x, where: seq.Shard) -> torch.Tensor:
        if not own:
            own.append(copy.deepcopy(model))
        x = torch.as_tensor(x).to(device).to(torch.float32)
        calls["module"] += 1
        with precision(), batchnorm.positions(where):
            pred = torch.func.functional_call(
                own[0], params, (x,), seq.forward_kwargs(arch, where))
        return seq.own_output(arch, pred, where)

    pipe.shard = shard
    return pipe


@functools.lru_cache(maxsize=None)
def _zoo_skeleton(name: str, dtype: torch.dtype, threshold: Optional[float],
                  max_echoes: int, arch: tuple
                  ) -> Tuple[torch.nn.Module, int, Dict[str, tuple]]:
    """The zoo family's module of ``build_model(name, **dict(arch))`` on
    the meta device in eval mode, its decode's upsample factor and the
    shapes of its state; cached, as :func:`_meta_module` is for StofNet."""
    overrides = dict(arch)
    model, updates = build_model(name, th=threshold, dtype=dtype,
                                 device="meta", **overrides)
    model.eval()
    if name == "gradpeak":
        model.max_echoes = max_echoes
    up = int(updates.get("upsample_factor",
                         overrides.get("upsample_factor", 4)))
    return model, up, {k: tuple(v.shape)
                       for k, v in model.state_dict().items()}


def _arch_key(overrides: Mapping[str, Any]) -> tuple:
    """``overrides`` as a hashable cache key."""
    return tuple(sorted((k, tuple(v) if isinstance(v, (list, tuple)) else v)
                        for k, v in overrides.items()))


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
                          model_name: str = "stofnet",
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
    route, as JAX's probe runs the pipeline it is asked about. For a
    ``model_name`` of the zoo both legs run its :func:`zoo_pipeline`."""
    x = gate_batch(batch, length, np.random.default_rng(seed))
    decode = dict(window_size=window_size, threshold=threshold,
                  max_echoes=max_echoes)
    if model_name.lower() != "stofnet":
        bf16, f32 = (zoo_pipeline(state, overrides, model_name, dtype=dt,
                                  device=dev, **decode)(x).cpu().numpy()
                     for dt, dev in ((torch.bfloat16, device),
                                     (torch.float32, "cpu")))
    elif int8_calib is not None:
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


def _skeleton(dtype: torch.dtype, overrides: Mapping[str, Any]
              ) -> Tuple[StofNet, Dict[str, tuple]]:
    """``StofNet(dtype=dtype, **overrides)`` on the meta device, the module
    route's structure without data, and the shapes of its state. Cached
    per type and architecture, so that a pipeline built inside a trace
    (the weightless export) finds the one built before it: a module cannot
    be built, nor its parameters read, inside a trace."""
    return _meta_module(dtype, _arch_key(overrides))


@functools.lru_cache(maxsize=None)
def _meta_module(dtype: torch.dtype, arch: tuple
                 ) -> Tuple[StofNet, Dict[str, tuple]]:
    with torch.device("meta"):
        module = StofNet(dtype=dtype, device="meta", **dict(arch))
    return module, {k: tuple(v.shape) for k, v in module.state_dict().items()}


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


def encoded_input_specs(enc: Optional[str], batch: Union[int, str],
                        length: int, device: DeviceLike = "cpu"
                        ) -> Tuple[Tuple[torch.Tensor, ...], tuple]:
    """The example inputs a program of ``input_enc=enc`` is traced with,
    on ``device``, and their dynamic shapes: the (batch, 1, length)
    waveform in f32 (or bf16), or the codes and their scales. ``batch`` as
    an int pins it; as a name (``"b"``) it becomes one ``torch.export.Dim``
    (min 1), traced at EXAMPLE_BATCH."""
    kind, n = parse_input_enc(enc)
    poly = isinstance(batch, str)
    b = EXAMPLE_BATCH if poly else int(batch)
    wave = (b, 1, length)
    if kind in ("f32", "bf16"):
        specs = [(wave, torch.float32 if kind == "f32" else torch.bfloat16)]
    elif kind == "s16":
        specs = [(wave, torch.int16), ((b, 1, 1), torch.float32)]
    else:
        chunk_len(length, n)  # the chunk count divides the length
        specs = [(wave, torch.int8), ((b, 1, n), torch.float32)]
    examples = tuple(torch.zeros(shape, dtype=dt, device=device)
                     for shape, dt in specs)
    dim = torch.export.Dim(batch, min=1) if poly else None
    return examples, tuple({0: dim} if poly else None for _ in examples)


class _Program(torch.nn.Module):
    """A serving callable as the module ``torch.export`` traces."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *inputs):
        return self.fn(*inputs)


def _trace(fn: Callable, inputs: tuple,
           dynamic: tuple) -> torch.export.ExportedProgram:
    """``fn`` traced on ``inputs``; the program keeps no example inputs,
    which ``torch.export.save`` would write beside it (a weightless
    program's would be its weights)."""
    program = torch.export.export(_Program(fn), inputs,
                                  dynamic_shapes=(dynamic,))
    program.example_inputs = None
    return program


def export_pipeline(state: Mapping[str, Any], overrides: Dict[str, Any],
                    batch: Union[int, str], length: int, *,
                    device: DeviceLike = None,
                    **pipe_kwargs) -> torch.export.ExportedProgram:
    """``make_pipeline(state, overrides, device=device, **pipe_kwargs)``
    traced for a (batch, 1, length) input (the inputs of
    :func:`encoded_input_specs` with ``input_enc=``) on ``device`` (the
    card when None). The length is static; ``batch`` an int or a name
    (one batch-polymorphic program). The weights, the int8 route's
    calibrated state and the kernels' weight layouts are baked in as
    constants; the kernels appear as their custom ops."""
    device = resolve_device(device)
    examples, dynamic = encoded_input_specs(pipe_kwargs.get("input_enc"),
                                            batch, length, device)
    pipe = make_pipeline(state, overrides, device=device, **pipe_kwargs)
    return _trace(pipe, examples, dynamic)


def export_pipeline_weightless(
        state: Mapping[str, Any], overrides: Dict[str, Any],
        batch: Union[int, str], length: int, *, device: DeviceLike = None,
        **pipe_kwargs) -> Tuple[torch.export.ExportedProgram,
                                Dict[str, np.ndarray]]:
    """:func:`export_pipeline` with the state dict (reference torch names)
    as the program's first input instead of constants: returns the program
    and the weights to save as its sidecar (``save_pipeline(path, program,
    weights=...)``). The kernels' weight layouts are then traced into the
    program and run on every call. int8 is refused, as in JAX: its
    calibrated state is baked by design."""
    if (pipe_kwargs.get("int8_calib") is not None
            or pipe_kwargs.get("int8_stack_layers")):
        raise ValueError("bake_weights=False does not compose with int8 "
                         "exports (the quantized state is baked by "
                         "design); drop int8_calib or bake the weights")
    device = resolve_device(device)
    weights = {k: _tensor(v).to(device) for k, v in state.items()}
    # checks the state and builds the module route's skeleton outside the
    # trace, where the pipeline traced below finds it
    make_pipeline(weights, overrides, device=device, **pipe_kwargs)
    examples, dynamic = encoded_input_specs(pipe_kwargs.get("input_enc"),
                                            batch, length, device)

    def pipe_w(weights, *data):
        return make_pipeline(weights, overrides, device=device,
                             **pipe_kwargs)(*data)

    program = _trace(pipe_w, (weights, *examples),
                     (dict.fromkeys(weights), *dynamic))
    return program, {k: v.cpu().numpy() for k, v in weights.items()}


def _flatten_tree(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested mapping of arrays -> flat ``a/b/c`` keys (the sidecar's
    layout); a state dict is flat already."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if hasattr(v, "items"):
            out.update(_flatten_tree(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten_tree(flat: Mapping[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key in flat:
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = flat[key]
    return out


def save_pipeline(path: Union[str, Path],
                  program: torch.export.ExportedProgram,
                  weights: Optional[Mapping[str, Any]] = None) -> Path:
    """Write the program (``torch.export.save``); with ``weights`` (a
    weightless export's) also the ``<path>.weights.npz`` sidecar that
    :func:`load_pipeline` finds."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(program, str(path))
    if weights is not None:
        np.savez(str(path) + ".weights.npz", **_flatten_tree(weights))
    return path


def _detect_input_enc(specs: Sequence[Any]) -> Tuple[str, int]:
    """The ``input_enc`` of a program from its trailing inputs (anything
    with ``dtype`` and ``shape``): int8 codes with (b, 1, n) f32 scales
    -> ``s8c<n>``; int16 codes with (b, 1, 1) f32 scales -> ``s16``; a
    bf16 waveform -> ``bf16``; else ``f32``. Returns (enc, number of data
    inputs), as JAX's does from its avals."""
    if len(specs) >= 2:
        codes, scales = specs[-2], specs[-1]
        if codes.dtype == torch.int8 and scales.dtype == torch.float32:
            return f"s8c{int(scales.shape[-1])}", 2
        if (codes.dtype == torch.int16 and scales.dtype == torch.float32
                and int(scales.shape[-1]) == 1):
            return "s16", 2
    if specs[-1].dtype == torch.bfloat16:
        return "bf16", 1
    return "f32", 1


def _spec(val: torch.Tensor) -> TensorSpec:
    """A traced input's spec: a symbolic size by its symbol's name."""
    return TensorSpec(tuple(d if isinstance(d, int) else str(d)
                            for d in val.shape), val.dtype)


def load_pipeline(path: Union[str, Path], device: DeviceLike = None
                  ) -> Callable:
    """Load a program of :func:`save_pipeline`; returns ``f(x) -> coords``
    on the program's device, with no model code or checkpoint. A
    ``<path>.weights.npz`` sidecar (a weightless export's) is found and
    copied to the device once. Host arrays are copied onto the device
    before each call (the program asserts its inputs' device and type),
    and the call runs under ``full_f32`` (no TF32) and inference mode.

    An encoded-input program (``input_enc=``) is recognized from its
    inputs (:func:`_detect_input_enc`): ``f`` still takes f32 waveforms
    and encodes them on the host. Attributes as JAX's, under torch names:
    ``in_specs`` (the waveform input; its batch an int or a symbol's
    name), ``input_enc``, ``encode``, ``raw_call`` (the program on the
    encoded inputs), ``raw_in_specs`` and ``device``.

    A program serves on the device it was exported for: ``device=``
    another one raises (a departure from JAX's artifacts, lowered for the
    CPU and the TPU at once)."""
    # the custom ops a program names are registered on import
    import stofnet_tpu_torch.ops.kernels  # noqa: F401
    program = torch.export.load(str(path))
    user = set(program.graph_signature.user_inputs)
    vals = [n.meta["val"] for n in program.graph.nodes
            if n.op == "placeholder" and n.name in user]
    enc, n_data = _detect_input_enc(vals)
    data = vals[-n_data:]
    where = data[0].device
    if device is not None and torch.device(device) != where:
        raise ValueError(f"load_pipeline: {path} was exported for {where} "
                         f"and serves there, not on {torch.device(device)}; "
                         f"export it again with device={torch.device(device)}")
    sidecar = Path(str(path) + ".weights.npz")
    weights = ()
    if sidecar.exists():
        with np.load(sidecar) as z:
            weights = (_unflatten_tree({k: torch.from_numpy(z[k]).to(where)
                                        for k in z.files}),)
    module = program.module()
    specs = [_spec(v) for v in data]

    def raw_call(*inputs) -> torch.Tensor:
        inputs = [torch.as_tensor(a).to(device=where, dtype=s.dtype)
                  for a, s in zip(inputs, specs)]
        with torch.inference_mode(), full_f32():
            return module(*weights, *inputs)

    encode = make_input_encoder(enc)
    if enc == "f32":
        call = raw_call
    else:
        def call(x):
            return raw_call(*encode(x))
    call.in_specs = tuple(specs[:1])
    call.input_enc = enc
    call.encode = encode
    call.raw_call = raw_call
    call.raw_in_specs = tuple(specs)
    call.device = where
    return call
