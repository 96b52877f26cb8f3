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
``export_pipeline`` traces that callable with ``torch.export`` into an
artifact of a static length (:class:`PipelineExport`): the forward,
polymorphic in the length of a window on the family's grid so that it
also serves each length shard's window (a forward that joins inside, the
int8 route's, Zonzini's and Kuleshov's: its stages, each a program
polymorphic in its inputs' widths, the joins between them in the
manifest, ``utils/stages``), and the decode of whole rows; the weights
and the kernels' weight layouts baked in (the two kernels are custom
ops, ``ops/kernels``). ``export_pipeline_weightless`` takes the state
dict as the forward's inputs instead; ``save_pipeline`` /
``load_pipeline`` write and serve the file with no model code, on any
device of the kind it was exported for. Departure from JAX, whose
artifacts are lowered for ``platforms=("cpu", "tpu")``: a program serves
on the kind of device it was exported for, because the device chooses
the route (``fused_takes``: f32 on the card takes the module route, on
the CPU the fused forward).

Every f32 route computes without TF32 (``ops/conv.full_f32``), as the JAX f32
pipeline sums in full f32, whatever the caller's flags.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import io
import json
import zipfile
from pathlib import Path
from typing import (
    Any, Callable, Dict, List, Mapping, NamedTuple, Optional, Sequence,
    Tuple, Union,
)

import numpy as np
import torch
from torch.export.passes import move_to_device_pass

from stofnet_tpu_torch import DeviceLike, resolve_device
from stofnet_tpu_torch.data.synthetic import gate_batch
from stofnet_tpu_torch.models.fused import FUSED_SCALES, fused_forward
from stofnet_tpu_torch.models import batchnorm
from stofnet_tpu_torch.models.int8 import (
    QCONFIG, int8_stages, quantize_stofnet, stofnet_apply_int8,
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
from stofnet_tpu_torch.utils import profiling
from stofnet_tpu_torch.utils.stages import (
    Stage, run_stages, stage_record, takes,
)

# the architecture arguments stofnet_apply_fused takes; the fused path has
# the default widths and kernel sizes
FUSED_OVERRIDES = ("upsample_factor", "num_blocks", "semi_global_scale")
# the example batch a batch-polymorphic export traces with: at least 2, so
# that the batch is not specialized to a constant
EXAMPLE_BATCH = 2
# the layout of an artifact (PipelineExport): a zip of the manifest, the
# forward's programs (a joining forward's stages) and the decode; a file of
# one program is an artifact written before layouts. Layout 2 wrote every
# forward as one program: it still loads, and a joining forward of it
# serves the row only
ARTIFACT_FORMAT = 3
LAYOUTS = (2, ARTIFACT_FORMAT)
MANIFEST = "stofnet_artifact.json"


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


def encoded_window(coded: Sequence[Any], enc: Optional[str], start: int,
                   stop: int) -> tuple:
    """The host's part of a length shard's encoded input: of a slice's
    inputs ``coded`` (``make_input_encoder(enc)``'s, whole rows), the codes
    of the window [start, stop) and the scales those codes need (s16: the
    row's; s8c: the chunks the window touches); f32 and bf16 are their
    own codes. No more than this is copied to the shard's device."""
    kind, n = parse_input_enc(enc)
    codes = coded[0][..., start:stop]
    if kind in ("f32", "bf16"):
        return (codes,)
    if kind == "s16":
        return codes, coded[1]
    cl = chunk_len(coded[0].shape[-1], n)
    return codes, coded[1][..., start // cl:-(-stop // cl)]


def dequantize(inputs: Sequence[Any], enc: Optional[str], start: int,
               length: int, device: torch.device) -> torch.Tensor:
    """``inputs`` (:func:`encoded_window`'s, or a whole row's at ``start``
    0) copied to ``device`` and dequantized there, as the f32 waveform
    (B, 1, window) the forward takes: ``codes * scale`` in f32, the numpy
    codecs' bits; each s8c position takes its chunk's scale, the chunks
    ``length / n`` samples of the row of ``length``."""
    kind, n = parse_input_enc(enc)
    codes = torch.as_tensor(inputs[0]).to(device)
    if kind in ("f32", "bf16"):
        return codes.to(torch.float32)
    scales = torch.as_tensor(inputs[1]).to(device)
    if kind == "s8c":
        cl = chunk_len(length, n)
        pos = torch.arange(start, start + codes.shape[-1], device=device)
        scales = scales[..., pos // cl - start // cl]
    return codes.to(torch.float32) * scales


def _wrap_input_enc(pipe: Callable, enc: Optional[str],
                    device: torch.device) -> Callable:
    """``pipe`` taking the encoded inputs of ``input_enc=enc``: the codes
    are copied to ``device`` and dequantized there (:func:`dequantize`),
    in the span ``h2d``. f32 and bf16 inputs go to ``pipe`` as they are:
    its input cast absorbs a bf16 input. The forward alone
    (``heatmap``, ``shard``) takes the dequantized window, as an
    artifact's."""
    kind, _ = parse_input_enc(enc)
    if kind in ("f32", "bf16"):
        return pipe

    def load(codes, scales):
        return dequantize((codes, scales), enc, 0, codes.shape[-1], device)
    return pipe.taking(load)


def _to_card(x, device: torch.device) -> torch.Tensor:
    """Frames (B, 1, L) copied to ``device`` as f32: the pipelines'
    copy-in, in the span ``h2d`` (:func:`_pipeline`)."""
    return torch.as_tensor(x).to(device).to(torch.float32)


def _pipeline(forward: Callable, decode: Callable, device: torch.device, *,
              shard: Optional[Callable] = None,
              load: Optional[Callable] = None, first: Optional[list] = None,
              **attrs) -> Callable:
    """The serving callable of a forward ``forward(x, **kw)`` on f32
    frames on ``device`` and its ``decode``, and its entries, each in
    inference mode and under the program's spans
    (``utils/profiling.span``):

    - ``pipe(*inputs)``: the root span ``call`` holding ``h2d`` (``load``
      of the inputs, by default :func:`_to_card` of the frames),
      ``forward`` and ``decode``; with no profiler running, one check;
    - ``pipe.heatmap(x, **kw)``, the forward alone: ``heatmap`` holding
      ``h2d`` (:func:`_to_card`) and ``forward``;
    - ``pipe.decode(heat)``: ``decode``;
    - given ``shard``, ``pipe.shard(x, where)``, ``shard(x, where)`` on
      the frames: ``call`` holding ``h2d`` and ``forward``;
    - ``pipe.taking(load)``: the pipeline on other inputs, ``load``
      copying them in.

    The first call of any entry (``first``, shared with ``taking``'s)
    lies in the set-up stage ``first_call`` (``utils/profiling.once``).
    ``attrs`` are set on the callable (``route``, ``calls``, ...)."""
    first = [True] if first is None else first
    to_card = functools.partial(_to_card, device=device)
    load = to_card if load is None else load
    span = profiling.span

    def first_call(entry: Callable, *args, **kw):
        first.clear()
        with profiling.once("first_call"):
            return entry(*args, **kw)

    @torch.inference_mode()
    def pipe(*inputs) -> torch.Tensor:
        if first:
            return first_call(pipe, *inputs)
        if not profiling.enabled():
            return decode(forward(load(*inputs)))
        with span("call"):
            with span("h2d"):
                x = load(*inputs)
            with span("forward"):
                heat = forward(x)
            with span("decode"):
                return decode(heat)

    def forward_alone(root: str, fn: Callable) -> Callable:
        @torch.inference_mode()
        def entry(x, *args, **kw) -> torch.Tensor:
            if first:
                return first_call(entry, x, *args, **kw)
            with span(root):
                with span("h2d"):
                    x = to_card(x)
                with span("forward"):
                    return fn(x, *args, **kw)
        return entry

    @torch.inference_mode()
    def decode_alone(heat) -> torch.Tensor:
        if first:
            return first_call(decode_alone, heat)
        with span("decode"):
            return decode(heat)

    pipe.heatmap = forward_alone("heatmap", forward)
    pipe.decode = decode_alone
    if shard is not None:
        pipe.shard = forward_alone("call", shard)
    pipe.taking = lambda load: _pipeline(
        forward, decode, device, shard=shard, load=load, first=first,
        **attrs)
    for k, v in attrs.items():
        setattr(pipe, k, v)
    return pipe


def make_pipeline(state: Mapping[str, Any], overrides: Dict[str, Any], *,
                  model_name: str = "stofnet",
                  window_size: int = 20, threshold: Optional[float] = None,
                  max_echoes: int = 64, dtype: Optional[torch.dtype] = None,
                  device: DeviceLike = None, int8_calib: Any = None,
                  int8_stack_layers: Optional[Sequence[int]] = None,
                  int8_eq_alpha: Optional[float] = None,
                  int8_bias_correct: bool = False,
                  input_enc: Optional[str] = None,
                  int8_state: Optional[Mapping[str, Any]] = None) -> Callable:
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
      convs in s8 (``quantize_stofnet``). Calibrate on echo-bearing data.
      ``int8_calib`` goes through :func:`calibrate_int8`, whose state
      ``int8_state`` takes in its place (calibrated once for several
      pipelines; the ``int8_stack_layers`` it was built with still
      given);
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
    forward on each shard's window and decodes the joined rows. The int8
    route's activation scales are maxima over the row, so its shards
    join inside the forward: ``pipe.shard(x, shard)`` runs it on a
    ``parallel/seq.Shard``'s window (the row's scales joined through the
    shard's exchange) and returns the shard's own positions, its
    ``arch`` says ``int8``, and ``pipe.stages_on()`` gives its stages and
    joins (``models/int8.int8_stages``), which the exporter traces.

    ``model_name`` other than ``stofnet`` serves that model of the
    registry through :func:`zoo_pipeline` (no int8, as in JAX).

    Every call of the callable and of its entries is marked by the
    program's spans (:func:`_pipeline`, ``utils/profiling``): ``call``
    holding ``h2d`` (the copy of the inputs to the card and their cast,
    an encoded input's dequantization included), ``forward`` and
    ``decode``. They appear as ``stofnet.*`` events in any
    ``torch.profiler`` trace of the process, and cost one check a call
    with no profiler running; the pipeline's first call is the set-up
    stage ``first_call``.

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
        if (int8_calib is not None or int8_stack_layers
                or int8_state is not None):
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
    if int8_state is None and int8_calib is not None:
        int8_state = calibrate_int8(params, overrides, int8_calib,
                                    int8_stack_layers=int8_stack_layers,
                                    int8_eq_alpha=int8_eq_alpha,
                                    int8_bias_correct=int8_bias_correct)
    if int8_state is not None:
        qkw, stack = _int8_config(overrides, int8_stack_layers)
        q = _to_device(int8_state, device)

        def int8(x, shard=None):
            return stofnet_apply_int8(q, x, dtype=dtype, stack_layers=stack,
                                      shard=shard, **qkw)

        def stages_on(weights=None):
            return int8_stages(q, dtype=dtype, stack_layers=stack, **qkw)
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

    def heatmap(x: torch.Tensor) -> torch.Tensor:
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

    arch = seq.stofnet_arch(overrides, int8=int8 is not None)
    if int8 is None:
        pipe = _pipeline(heatmap, decode, device, route=route, calls=calls,
                         arch=arch)
    else:
        def shard(x: torch.Tensor, where: seq.Shard) -> torch.Tensor:
            calls["int8"] += 1
            with precision():
                return seq.own_output(arch, int8(x, where), where)

        pipe = _pipeline(heatmap, decode, device, shard=shard, route=route,
                         calls=calls, arch=arch, stages_on=stages_on)
    return _wrap_input_enc(pipe, input_enc, device)


def calibrate_int8(state: Mapping[str, Any], overrides: Dict[str, Any],
                   calib: Any, *,
                   int8_stack_layers: Optional[Sequence[int]] = None,
                   int8_eq_alpha: Optional[float] = None,
                   int8_bias_correct: bool = False) -> Dict[str, Any]:
    """The int8 route's state: ``quantize_stofnet`` of ``state`` (on its
    device) on the whole calibration batch ``calib``, with the overrides
    of ``models/int8.QCONFIG``, as :func:`make_pipeline` takes it."""
    qkw, stack = _int8_config(overrides, int8_stack_layers)
    params = {k: _tensor(v) for k, v in state.items()}
    return quantize_stofnet(params, calib, stack_layers=stack,
                            eq_alpha=int8_eq_alpha,
                            bias_correct=int8_bias_correct, **qkw)


def _int8_config(overrides: Mapping[str, Any],
                 stack_layers: Optional[Sequence[int]]
                 ) -> Tuple[Dict[str, int], Optional[Tuple[int, ...]]]:
    """The int8 forward's architecture keywords (the overrides of
    ``models/int8.QCONFIG``) and its s8 stack convs, None for none."""
    return ({k: int(v) for k, v in overrides.items() if k in QCONFIG},
            tuple(int(i) for i in stack_layers) if stack_layers else None)


def _to_device(tree: Any, device: torch.device) -> Any:
    """A nested dict of tensors copied to ``device``."""
    if isinstance(tree, Mapping):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


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
    the joined rows. ``pipe.heatmap(x, **kw)`` is the forward alone (the
    exporter's forward program): a windowed family's replicas run it on a
    shard's window (``kw``: the unet's ``shard``), as StofNet's do. Zonzini and Kuleshov join inside their
    forward (``parallel/seq.JOINED``): each replica of a dp row runs
    ``pipe.shard(x, shard)``, the forward as a ``parallel/seq.Shard``
    (its window, or Kuleshov's own samples; the joins through the shard's
    exchange), one thread each. ``functional_call`` swaps a module's
    tensors, so that form runs on a copy of the skeleton of its own,
    made at its first call (not inside a trace), and replicas run it on
    threads of their own. ``pipe.stages_on(weights=None)`` gives the
    family's stages and joins (``model.stages()``) run on ``weights``
    (state keys, a stage's own suffice; the pipeline's state when None),
    which the exporter traces."""
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

    def forward(x: torch.Tensor, **kw) -> torch.Tensor:
        calls["module"] += 1
        with precision():
            return torch.func.functional_call(model, params, (x,), kw)

    arch = seq.model_arch(model)
    attrs = dict(route=lambda length: "module", calls=calls, arch=arch)
    if arch["family"] not in seq.JOINED:
        return _pipeline(forward, finish, device, **attrs)
    own = []  # the shard form's skeleton

    def shard(x: torch.Tensor, where: seq.Shard) -> torch.Tensor:
        if not own:
            own.append(copy.deepcopy(model))
        calls["module"] += 1
        with precision(), batchnorm.positions(where):
            pred = torch.func.functional_call(
                own[0], params, (x,), seq.forward_kwargs(arch, where))
        return seq.own_output(arch, pred, where)

    return _pipeline(forward, finish, device, shard=shard,
                     stages_on=lambda weights=None: _bound_stages(
                         model, params if weights is None else weights),
                     **attrs)


class _StageCall(torch.nn.Module):
    """Stage ``k`` of ``model.stages()`` as a module's forward, so that
    ``functional_call`` runs it on tensors of the caller's."""

    def __init__(self, model: torch.nn.Module, k: int):
        super().__init__()
        self.model, self.k = model, k

    def forward(self, *reads):
        return self.model.stages()[0][self.k].fn(*reads)


def _bound_stages(model: torch.nn.Module, params: Mapping[str, Any]):
    """A joining family's ``model.stages()`` (``utils/stages``) run on
    ``params`` (state keys; a stage's own suffice) through
    ``functional_call`` of the module, whose own tensors it leaves alone."""
    stages, joins = model.stages()
    prefixed = {f"model.{k}": v for k, v in params.items()}

    def bound(k):
        return lambda *reads: torch.func.functional_call(
            _StageCall(model, k), prefixed, reads)
    return [st._replace(fn=bound(k)) for k, st in enumerate(stages)], joins


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


class PipelineExport(NamedTuple):
    """An artifact: the pipeline's forward, as one program or a list of
    stage programs, and its decode.

    A windowed family's forward is one program (``stages[0]``, also
    ``forward``): it takes a (batch, 1, n) f32 window and gives its
    heatmap (or a regression family's prediction), polymorphic in n on its
    grid, ``grid * k + length % grid`` (k >= 2), so that one program
    serves every window ``parallel/seq.windows`` makes, at any sp that
    divides the length; the Wave-U-Net's also takes the window's start and
    the row's length (0-d int64 tensors), which its resample reads. A
    forward that joins inside (the int8 route, Zonzini, Kuleshov) is its
    stages (``utils/stages``), one program each, every read's width
    symbolic, with the joins between them in the manifest: the loader runs
    them with ``utils/stages.run_stages``, on the row or as a length
    shard. ``decode`` takes the whole rows' (batch, ...) output at the
    static length. ``meta`` is what :func:`load_pipeline` reads (JSON):
    the length, the batch (an int, or a polymorphic batch's name),
    ``input_enc``, the rule ``arch`` (``parallel/seq.model_arch``), ``sp``
    (``windows``; ``row``, GradPeak's whole-row window; ``joins``),
    ``takes_where``, ``device``, ``stages`` (each stage's name, reads,
    writes, layout and the state keys it takes as inputs, none where the
    weights are baked) and ``joins``, under ``format`` 3."""
    stages: List[torch.export.ExportedProgram]
    decode: torch.export.ExportedProgram
    meta: Dict[str, Any]

    @property
    def forward(self) -> torch.export.ExportedProgram:
        """A forward of one program (a windowed family's)."""
        if len(self.stages) != 1:
            raise AttributeError(f"this forward is {len(self.stages)} "
                                 f"stage programs, not one")
        return self.stages[0]


class _Where(NamedTuple):
    """A window's place, as an exported forward takes it: what the
    Wave-U-Net's forward reads of a ``parallel/seq.Shard``."""
    window: Tuple[torch.Tensor, None]
    length: torch.Tensor


def _sp_rule(arch: Mapping[str, Any]) -> str:
    """How an artifact's forward serves under sp (``PipelineExport``)."""
    family = seq.family_of(arch)
    if arch.get("int8") or family in seq.JOINED:
        return "joins"
    return "row" if arch.get("reach") == seq.ROW else "windows"


def _window_dim(arch: Mapping[str, Any], length: int):
    """A window's width on the family's grid, ``grid * k + length % grid``
    (k >= 2), as a ``torch.export`` dimension."""
    grid = int(arch.get("grid", arch.get("semi_global_scale", 1)))
    k = torch.export.Dim("k", min=2, max=max(2, length // grid))
    return grid * k + length % grid if grid > 1 else k


def _export(pipe: Callable, pipe_of: Callable, weights: Optional[dict],
            batch: Union[int, str], length: int, enc: Optional[str],
            device: torch.device) -> PipelineExport:
    """The programs of ``pipe`` (:class:`PipelineExport`): a windowed
    forward, ``pipe_of(*weights).heatmap`` on ``(*weights, x, *where)``,
    traced on an example of the whole row, or a joining forward's stages
    (:func:`_export_stages`); then ``pipe.decode`` on the example's
    output."""
    kind, n = parse_input_enc(enc)
    if kind == "s8c":
        chunk_len(length, n)  # the chunk count divides the length
    arch, rule = dict(pipe.arch), _sp_rule(pipe.arch)
    poly = isinstance(batch, str)
    bdim = torch.export.Dim(batch, min=1) if poly else None
    x = torch.zeros((EXAMPLE_BATCH if poly else int(batch), 1, length),
                    device=device)
    where = seq.family_of(arch) == "unet"
    if rule == "joins":
        stages, records, joins, heat = _export_stages(pipe, weights, bdim,
                                                      x)
    else:
        ldim = _window_dim(arch, length) if rule == "windows" else None
        at = ((torch.tensor(0, device=device),
               torch.tensor(length, device=device)) if where else ())
        dims = {i: d for i, d in ((0, bdim), (2, ldim))
                if d is not None} or None
        first = 0 if weights is None else 1

        def forward(*inputs):
            x, place = inputs[first], inputs[first + 1:]
            kw = {"shard": _Where((place[0], None), place[1])} if place else {}
            return pipe_of(*inputs[:first]).heatmap(x, **kw)

        given = () if weights is None else (weights,)
        stages = [_trace(forward, (*given, x, *at),
                         (*(dict.fromkeys(w) for w in given), dims,
                          *[None] * len(at)))]
        records = [{"name": "forward",
                    "reads": ["x", *(["start", "rows"] if where else [])],
                    "writes": ["heat"],
                    "layout": ["b1t", *([""] * len(at))],
                    "weights": None if weights is None else list(weights)}]
        joins, heat = [], forward(*given, x, *at)
    dec = _trace(pipe.decode, (heat,), ({0: bdim} if poly else None,))
    meta = dict(format=ARTIFACT_FORMAT, length=int(length), batch=batch,
                input_enc=enc or "f32", arch=arch, sp=rule,
                takes_where=where, device=str(device), stages=records,
                joins=joins)
    return PipelineExport(stages, dec, meta)


def _export_stages(pipe: Callable, weights: Optional[dict], bdim,
                   x: torch.Tensor):
    """A joining forward's stage programs (``pipe.stages_on``), each traced
    on the reads it takes in a whole-row run of the example ``x``, with
    the batch ``bdim`` and every read's time axis symbolic in the form its
    stage gives (``utils/stages.Stage.widths``; one dimension for the reads
    of one form). A trace that pins a width raises: no stage falls back
    to the row's program. Returns (programs, their manifest records, the
    joins, the example's output)."""
    stages, joins = pipe.stages_on()
    seen: List[tuple] = []
    a, b = seq.row_span(pipe.arch, x.shape[-1])
    with torch.inference_mode():
        heat = run_stages(stages, joins, {"x": x[..., a:b]}, None, seen)
    programs, records = [], []
    for k, (st, reads) in enumerate(zip(stages, seen)):
        own = {} if weights is None else {n: v for n, v in weights.items()
                                          if takes(st, n)}
        forms: Dict[tuple, Any] = {}
        dims, symbolic = [], []
        for name, spec, form, t in zip(st.reads, st.layout, st.widths,
                                       reads):
            d = {a: bdim for a, c in enumerate(spec) if c == "b" and bdim}
            if "t" in spec:
                axis = spec.index("t")
                width = _width_dim(form, x.shape[-1], t.shape[axis], forms)
                if width is not None:
                    d[axis] = width
                    symbolic.append((name, axis))
            dims.append(d or None)
        if weights is None:
            program = _trace(st.fn, reads, tuple(dims))
        elif not own:  # a stage that reads no weights takes none
            program = _trace(functools.partial(_on(pipe, k), {}), reads,
                             tuple(dims))
        else:
            program = _trace(_on(pipe, k), (own, *reads),
                             (dict.fromkeys(own), *dims))
        _check_symbolic(program, st, symbolic)
        programs.append(program)
        records.append(dict(stage_record(st), weights=list(own) or None))
    return programs, records, joins, heat


def _width_dim(form: Tuple[int, Optional[int], int], length: int,
               width: int, forms: Dict[tuple, Any]):
    """The ``torch.export`` dimension of a read's width ``grid * n +
    offset`` (n >= least; offset None: ``length`` modulo the grid), from
    its whole-row width, the largest: ``grid * k + offset - grid * (2 -
    least)`` with k >= 2 (a size the trace takes as 0 or 1 it would pin).
    One per form, kept in ``forms``; None where only one width exists."""
    grid, offset, least = form
    offset = length % grid if offset is None else offset
    most = (width - offset) // grid
    key = (grid, offset, least)
    if key not in forms:
        forms[key] = None if most <= least else (
            grid * torch.export.Dim(f"n{len(forms)}", min=2,
                                    max=most - least + 2)
            + offset - grid * (2 - least))
    return forms[key]


def _on(pipe: Callable, k: int) -> Callable:
    """Stage ``k`` of ``pipe``'s joining forward on weights it is given."""
    return lambda own, *reads: pipe.stages_on(own)[0][k].fn(*reads)


def _check_symbolic(program: torch.export.ExportedProgram, stage: Stage,
                    symbolic: Sequence[Tuple[str, int]]) -> None:
    """Raise where a stage's trace pinned the width of a read's time axis
    that takes more than one width (``symbolic``: the reads and axes): a
    guard the trace could not keep symbolic."""
    user = set(program.graph_signature.user_inputs)
    vals = [n.meta["val"] for n in program.graph.nodes
            if n.op == "placeholder" and n.name in user]
    by_name = dict(zip(stage.reads, vals[len(vals) - len(stage.reads):]))
    for name, axis in symbolic:
        width = by_name[name].shape[axis]
        if isinstance(width, int):
            raise ValueError(
                f"stage {stage.name}: the trace pinned the width of {name} "
                f"(axis {axis}) to {width}; a stage program must take "
                f"every shard's width")


def export_pipeline(state: Mapping[str, Any], overrides: Dict[str, Any],
                    batch: Union[int, str], length: int, *,
                    device: DeviceLike = None,
                    **pipe_kwargs) -> PipelineExport:
    """``make_pipeline(state, overrides, device=device, **pipe_kwargs)``
    exported as its forward and its decode (:class:`PipelineExport`) for
    (batch, 1, length) rows on ``device`` (the card when None): the
    length static (a windowed family's forward also takes its windows, a
    joining forward's stages every shard's widths), ``batch`` an int or a
    name (batch-polymorphic). The weights, the int8 route's calibrated
    state and the kernels' weight layouts are baked in as constants; the
    kernels appear as their custom ops. With ``input_enc=`` the artifact
    takes that encoding: the host encodes, the serving device dequantizes
    (:func:`dequantize`), and the forward takes the dequantized f32
    window, so one program serves whole rows and windows alike."""
    device = resolve_device(device)
    enc = pipe_kwargs.pop("input_enc", None)
    pipe = make_pipeline(state, overrides, device=device, **pipe_kwargs)
    return _export(pipe, lambda: pipe, None, batch, length, enc, device)


def export_pipeline_weightless(
        state: Mapping[str, Any], overrides: Dict[str, Any],
        batch: Union[int, str], length: int, *, device: DeviceLike = None,
        **pipe_kwargs) -> Tuple[PipelineExport, Dict[str, np.ndarray]]:
    """:func:`export_pipeline` with the state dict (reference torch names)
    as the forward's first input instead of constants (a joining
    forward's stages each take only the state keys it reads): returns the
    artifact and the weights to save as its sidecar (``save_pipeline(path,
    artifact, weights=...)``). The kernels' weight layouts are then traced
    into the forward and run on every call. int8 is refused, as in JAX:
    its calibrated state is baked by design."""
    if (pipe_kwargs.get("int8_calib") is not None
            or pipe_kwargs.get("int8_stack_layers")):
        raise ValueError("bake_weights=False does not compose with int8 "
                         "exports (the quantized state is baked by "
                         "design); drop int8_calib or bake the weights")
    device = resolve_device(device)
    enc = pipe_kwargs.pop("input_enc", None)
    weights = {k: _tensor(v).to(device) for k, v in state.items()}
    # checks the state and builds the module route's skeleton outside the
    # trace, where the pipeline traced below finds it
    pipe = make_pipeline(weights, overrides, device=device, **pipe_kwargs)

    def pipe_of(w):
        return make_pipeline(w, overrides, device=device, **pipe_kwargs)

    art = _export(pipe, pipe_of, weights, batch, length, enc, device)
    return art, {k: v.cpu().numpy() for k, v in weights.items()}


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


def save_pipeline(path: Union[str, Path], artifact: PipelineExport,
                  weights: Optional[Mapping[str, Any]] = None) -> Path:
    """Write the artifact: one zip of its manifest (``meta``), its stage
    programs and its decode (``torch.export.save`` each); with ``weights``
    (a weightless export's) also the ``<path>.weights.npz`` sidecar that
    :func:`load_pipeline` finds."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    programs = {f"stage{k}": p for k, p in enumerate(artifact.stages)}
    programs["decode"] = artifact.decode
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        z.writestr(MANIFEST, json.dumps(artifact.meta))
        for name, program in programs.items():
            buf = io.BytesIO()
            torch.export.save(program, buf)
            z.writestr(f"{name}.pt2", buf.getvalue())
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
    """Load an artifact of :func:`save_pipeline`; returns ``f(x) ->
    coords`` on ``device`` (the device it was exported for when None),
    with no model code or checkpoint: ``decode(forward(x))``, the rows of
    the one program of an artifact written before the forward and the
    decode were exported apart. On another device of the same kind (a
    card of a mesh) the programs are moved there
    (``torch.export.passes.move_to_device_pass``: the baked weights and
    the kernels' weight layouts copied, bit for bit); another kind of
    device raises, because the device chooses the route (``fused_takes``).
    A ``<path>.weights.npz`` sidecar (a weightless export's) is found and
    copied to the device once; each program is given the state keys its
    manifest names. Host arrays are copied onto the device before each
    call, and the call runs under ``full_f32`` (no TF32) and inference
    mode.

    An encoded-input artifact (``input_enc=``) still takes f32 waveforms
    and encodes them on the host. Attributes as JAX's, under torch names:
    ``in_specs`` (the waveform input; its batch an int or a symbol's
    name), ``input_enc``, ``encode``, ``raw_call`` (the artifact on the
    encoded inputs), ``raw_in_specs`` and ``device``; and, as
    ``make_pipeline``'s, ``heatmap(x[, shard=])`` (the forward on a
    dequantized f32 window of the whole row; the Wave-U-Net's reads the
    shard's place), ``decode``, ``arch`` and ``length``, ``format`` (the
    artifact's layout, :data:`LAYOUTS`), and ``sp``, how it serves under
    sp (:class:`PipelineExport`; None for an artifact of one program,
    which serves at sp = 1 only). A forward that joins inside, exported as
    its stages, also has ``shard(x, shard)``: the stages run as a
    ``parallel/seq.Shard`` (``utils/stages.run_stages``, each join through
    the shard's exchange), the shard's own output returned
    (``parallel/seq.own_output``); layout 2 wrote such a forward as one
    program, which serves the row only."""
    # the custom ops a program names are registered on import
    import stofnet_tpu_torch.ops.kernels  # noqa: F401
    with zipfile.ZipFile(path) as z:
        if MANIFEST not in z.namelist():
            return _load_one_program(path, device)
        meta = json.loads(z.read(MANIFEST))
        if meta.get("format") not in LAYOUTS:
            raise ValueError(f"load_pipeline: {path} has layout "
                             f"{meta.get('format')}, not one of {LAYOUTS}")
        names = (["forward"] if meta["format"] == 2 else
                 [f"stage{k}" for k in range(len(meta["stages"]))])
        programs = [torch.export.load(io.BytesIO(z.read(f"{n}.pt2")))
                    for n in [*names, "decode"]]
    where = _serving_device(path, torch.device(meta["device"]), device)
    if where != torch.device(meta["device"]):
        programs = [move_to_device_pass(p, where) for p in programs]
    *mods, dec = (_program_module(p) for p in programs)
    side = _sidecar(path, where)
    records = meta.get("stages") or [
        {"weights": None if side is None else list(side)}]
    fns = [_given(m, None if r["weights"] is None else
                  {k: side[k] for k in r["weights"]})
           for m, r in zip(mods, records)]
    enc, length = meta["input_enc"], int(meta["length"])
    batch = meta["batch"]
    # the encoded inputs' specs, as the program of one artifact took them
    examples, _ = encoded_input_specs(enc, 1, length, "meta")
    specs = [TensorSpec((batch, *v.shape[1:]), v.dtype) for v in examples]
    staged = meta["sp"] == "joins" and meta["format"] >= 3
    if staged:
        stages = [Stage(r["name"], fn, tuple(r["reads"]), tuple(r["writes"]),
                        tuple(r["layout"])) for r, fn in zip(records, fns)]

    def forward(x: torch.Tensor, shard=None) -> torch.Tensor:
        if staged:
            if shard is None:
                a, b = seq.row_span(meta["arch"], x.shape[-1])
                x = x[..., a:b]
            return run_stages(stages, meta["joins"], {"x": x}, shard)
        at = ()
        if meta["takes_where"]:
            start, rows = ((0, x.shape[-1]) if shard is None
                           else (shard.window[0], shard.length))
            at = (torch.tensor(start, device=where),
                  torch.tensor(rows, device=where))
        return fns[0](x, *at)

    def heatmap(x, shard=None) -> torch.Tensor:
        x = torch.as_tensor(x).to(device=where, dtype=torch.float32)
        with torch.inference_mode(), full_f32():
            return forward(x, None if staged else shard)

    def decode(heat) -> torch.Tensor:
        with torch.inference_mode(), full_f32():
            return dec(heat)

    def raw_call(*inputs) -> torch.Tensor:
        inputs = [torch.as_tensor(a).to(s.dtype)
                  for a, s in zip(inputs, specs)]
        return decode(heatmap(dequantize(inputs, enc, 0, length, where)))

    call = _serving_call(raw_call, enc, specs, where)
    call.heatmap, call.decode, call.length = heatmap, decode, length
    call.arch, call.sp, call.format = meta["arch"], meta["sp"], meta["format"]
    if staged:
        def shard_of_row(x, shard) -> torch.Tensor:
            x = torch.as_tensor(x).to(device=where, dtype=torch.float32)
            with torch.inference_mode(), full_f32():
                return seq.own_output(call.arch, forward(x, shard), shard)

        call.shard = shard_of_row
    return call


def _program_module(program: torch.export.ExportedProgram
                    ) -> torch.nn.Module:
    """``program.module()``, whose input checks (``torch.export``'s pre-hook
    ``_check_input_constraints_pre_hook``: ranks, static sizes, and each
    symbolic width's form solved with sympy, about 2 ms a call on the
    card's host) run once for each signature of its inputs' shapes and
    dtypes: a signature checked once holds for every later call with it.
    Without that hook (another PyTorch) the module is as it is."""
    module = program.module()
    for key, hook in list(module._forward_pre_hooks.items()):
        name = getattr(hook, "__name__", "")
        if name == "_check_input_constraints_pre_hook":
            module._forward_pre_hooks[key] = _once_a_signature(hook)
    return module


def _once_a_signature(hook: Callable) -> Callable:
    checked: set = set()

    def check(module, args, kwargs):
        leaves = torch.utils._pytree.tree_leaves((args, kwargs))
        sig = tuple((tuple(v.shape), v.dtype) if isinstance(v, torch.Tensor)
                    else (type(v), v) for v in leaves)
        if sig not in checked:
            hook(module, args, kwargs)
            checked.add(sig)
    return check


def _given(program: Callable, weights: Optional[Dict[str, torch.Tensor]]
           ) -> Callable:
    """A loaded program with its weights (the state keys its manifest
    names; None where it takes none) given ahead of its other inputs."""
    if weights is None:
        return program
    return lambda *inputs: program(weights, *inputs)


def _serving_device(path, exported: torch.device,
                    device: DeviceLike) -> torch.device:
    """The device an artifact serves on: ``device``, or the one it was
    exported for when None; another kind of device raises."""
    where = exported if device is None else torch.device(device)
    if where.type == "cuda" and where.index is None:
        where = torch.device("cuda", 0)
    if where.type != exported.type:
        raise ValueError(f"load_pipeline: {path} was exported for "
                         f"{exported} and serves on a device of that kind, "
                         f"not on {where}; export it again with "
                         f"device={where}")
    return where


def _sidecar(path, where: torch.device
             ) -> Optional[Dict[str, torch.Tensor]]:
    """A weightless artifact's ``<path>.weights.npz`` on ``where`` (by
    state key); None without one."""
    sidecar = Path(str(path) + ".weights.npz")
    if not sidecar.exists():
        return None
    with np.load(sidecar) as z:
        return _unflatten_tree({k: torch.from_numpy(z[k]).to(where)
                                for k in z.files})


def _serving_call(raw_call: Callable, enc: str, specs: Sequence[TensorSpec],
                  where: torch.device) -> Callable:
    """``f(x)`` on f32 waveforms, encoding them on the host, with the
    attributes :func:`load_pipeline` names."""
    encode = make_input_encoder(enc)
    if enc == "f32":
        call = raw_call
    else:
        def call(x):
            return raw_call(*encode(x))
    call.in_specs = (TensorSpec(specs[0].shape, torch.float32),)
    call.input_enc = enc
    call.encode = encode
    call.raw_call = raw_call
    call.raw_in_specs = tuple(specs)
    call.device = where
    return call


def _load_one_program(path, device: DeviceLike) -> Callable:
    """An artifact written before the forward and the decode were
    exported apart: one ``torch.export`` program of the whole pipeline,
    on the device it was exported for (``device=`` another one raises). It
    serves whole rows, so not under sp (``sp`` None)."""
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
    module = _given(_program_module(program), _sidecar(path, where))
    specs = [_spec(v) for v in data]

    def raw_call(*inputs) -> torch.Tensor:
        inputs = [torch.as_tensor(a).to(device=where, dtype=s.dtype)
                  for a, s in zip(inputs, specs)]
        with torch.inference_mode(), full_f32():
            return module(*inputs)

    call = _serving_call(raw_call, enc, specs, where)
    call.sp = None
    return call
