"""Export the serving pipeline to a ``torch.export`` artifact (replaces
``stofnet_tpu/cli/export.py``), and the helpers the serving daemon shares
with it::

    python -m stofnet_tpu_torch.cli.export model_file=different-armadillo \
        ckpt_dir=ckpts length=8000 batch=b out=m.pt2 [th=Null] \
        [max_echoes=64] [window_size=20] [dtype=auto|bfloat16|float32] \
        [int8_calib=x.npy [int8_stack=4,8,10] [int8_eq_alpha=0.5]
         [int8_bias_correct=True]] [input_enc=bf16|s16|s8c<n>] \
        [bake_weights=False] [device=cpu]

The whole zoo exports behind the same switch: ``model=edsr|espcn|zonzini|
unet|sincnet|kuleshov|gradpeak`` (heatmap families decode as StofNet does,
zonzini and gradpeak give their ToA as it is), with the family's build
arguments ``dataset_kind=chirp|pala|rat``, ``rf_scale_factor=`` and
``upsample_factor=``, ``sample_num=`` (kuleshov, whose dense head is sized
by sample_num * rf_scale_factor, which must equal ``length=``), ``fs=``
(sincnet) and ``n_layers=`` (unet; 2 on chirp, 10 elsewhere); gradpeak
takes no ``model_file=``. The int8 keys are StofNet's only.

``batch=b`` (any name) exports a batch-polymorphic artifact, an int pins
the batch; the length is static: one artifact per length. The artifact
holds the forward and the decode of whole rows (``serve.PipelineExport``):
the forward also takes the windows of every sp that divides the length
(the daemon's ``mesh_sp``; a windowed family's forward is one program
polymorphic in the window's length, the Wave-U-Net's also takes the
window's place, GradPeak's runs on the row); a forward that joins
inside (``int8_calib=``, zonzini, kuleshov) is its stages, a program
each, every shard's widths symbolic, the joins in the manifest.
``dtype=auto``
(the default) probes bf16 against f32 on echo-bearing waveforms before
the input encoding is applied, as in JAX, and exports f32 where bf16
moves the decode. ``bake_weights=False`` takes the weights as the
program's inputs from a ``<out>.weights.npz`` sidecar. Serve the file
with ``serve.load_pipeline(out)`` or ``cli/serve.py artifact=out``.

Departures from the JAX exporter: ``device=`` (the card by default, as
every entry point of the port) takes the place of ``platforms=``, which
is refused: an artifact serves on devices of the kind it was exported
for, any card of a mesh (the device chooses the route,
``serve.fused_takes``).

Arguments are ``key=value`` pairs, each value parsed as the JAX package's
``yaml.safe_load`` parses it (``utils/config.parse_value``; no PyYAML).
"""

from __future__ import annotations

import sys
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from stofnet_tpu_torch import DeviceLike, resolve_device
from stofnet_tpu_torch.bench_paths import AGREE_MIN
from stofnet_tpu_torch.models.torch_import import stofnet_overrides
from stofnet_tpu_torch.serve import (
    export_pipeline, export_pipeline_weightless, probe_dtype_agreement,
    save_pipeline,
)
from stofnet_tpu_torch.train.checkpoint import (
    find_checkpoint, load_model_variables,
)
from stofnet_tpu_torch.utils.config import parse_value

INT8_KEYS = ("int8_calib", "int8_stack", "int8_eq_alpha", "int8_bias_correct")
ARCH_KEYS = ("num_features", "semi_global_scale", "num_blocks",
             "upsample_factor")
DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
          "float32": torch.float32, "f32": torch.float32}
_KNOWN_KEYS = frozenset({
    "model_file", "out", "ckpt_dir", "platforms", "th", "batch", "length",
    "window_size", "max_echoes", "int8_calib", "model", "dtype",
    "int8_stack", "int8_eq_alpha", "int8_bias_correct", "bake_weights",
    "input_enc", *ARCH_KEYS,
    # the zoo's build arguments (model= other than stofnet)
    "dataset_kind", "rf_scale_factor", "sample_num", "fs", "n_layers",
    "device",  # the port's own: cuda (default) or cpu
})


def parse_args(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """``key=value`` arguments (``sys.argv[1:]`` when None) -> dict; an
    empty value is None."""
    args: Dict[str, Any] = {}
    for arg in (sys.argv[1:] if argv is None else argv):
        if "=" not in arg:
            raise SystemExit(f"expected key=value, got {arg!r}; see "
                             f"module docstring")
        k, _, v = arg.partition("=")
        args[k.strip()] = parse_value(v) if v != "" else None
    return args


def resolve_variables_and_overrides(args: Dict[str, Any]
                                    ) -> Tuple[Dict[str, torch.Tensor],
                                               Dict[str, Any]]:
    """``model_file=``/``ckpt_dir=`` -> (state dict, overrides): a
    reference ``.pth`` or a checkpoint of ``train/checkpoint.py``, the
    architecture read from the tensors' shapes
    (``models/torch_import.stofnet_overrides``: only what differs from the
    defaults). ``num_features=``, ``semi_global_scale=``, ``num_blocks=``
    and ``upsample_factor=`` win over the shapes, as in JAX."""
    state = load_model_variables("stofnet", _resolve_ckpt_path(args))
    overrides = stofnet_overrides(state)
    for k in ARCH_KEYS:
        if args.get(k) is not None:
            overrides[k] = int(args[k])
    return state, overrides


def _resolve_ckpt_path(args: Dict[str, Any]) -> str:
    """The checkpoint of ``model_file=``: a prefix match in ``ckpt_dir``
    (default ``ckpts``), else ``model_file`` as a path. JAX's daemon also
    looks in the reference's checkpoint directory; the port hard-codes no
    such path: name it with ``ckpt_dir=``."""
    path = str(args["model_file"])
    resolved = find_checkpoint(args.get("ckpt_dir") or "ckpts", path)
    return str(resolved) if resolved is not None else path


def resolve_zoo_variables_and_overrides(args: Dict[str, Any], model: str
                                        ) -> Tuple[Dict[str, torch.Tensor],
                                                   Dict[str, Any]]:
    """(state dict, ``registry.build_model`` arguments) of a family other
    than StofNet, as JAX's: gradpeak has no parameters (no
    ``model_file=``); kuleshov needs ``sample_num=``, and its input length
    ``sample_num * rf_scale_factor`` must be the export's ``length=``;
    sincnet needs ``fs=``; the unet's depth is ``n_layers=``, else 2 on
    chirp and 10 on PALA or rat data."""
    kind = str(args.get("dataset_kind", "chirp"))
    overrides: Dict[str, Any] = {
        "dataset_kind": kind,
        "upsample_factor": int(args.get("upsample_factor") or 4),
        "rf_scale_factor": int(args.get("rf_scale_factor") or 10),
    }
    if model == "kuleshov":
        if args.get("sample_num") is None:
            raise SystemExit("model=kuleshov needs sample_num= (its dense "
                             "head is sized by sample_num*rf_scale_factor)")
        overrides["sample_num"] = int(args["sample_num"])
        n = overrides["sample_num"] * overrides["rf_scale_factor"]
        length = int(args.get("length", 8000))
        if n != length:
            raise SystemExit(
                f"kuleshov input_length sample_num*rf_scale_factor={n} "
                f"must equal the export length={length}")
    if model == "sincnet":
        if args.get("fs") is None:
            raise SystemExit("model=sincnet needs fs= (the sinc filterbank "
                             "is parameterized by the sample rate)")
        overrides["fs"] = float(args["fs"])
    if model == "gradpeak":
        return {}, overrides
    n_layers = args.get("n_layers")
    n_layers = int(n_layers) if n_layers is not None else (
        2 if kind == "chirp" else 10)
    if model == "unet":
        # the depth built must be the checkpoint's
        overrides["n_layers"] = n_layers
    return (load_model_variables(model, _resolve_ckpt_path(args),
                                 n_layers=n_layers), overrides)


def resolve_dtype(args: Dict[str, Any]):
    """``dtype=auto|bfloat16|float32`` -> a torch dtype, or ``"auto"``
    when unset or auto (the dtype gate then probes and picks)."""
    if args.get("dtype") in (None, "auto"):
        return "auto"
    if str(args["dtype"]) not in DTYPES:
        raise SystemExit(f"dtype= must be one of {sorted(DTYPES)} or auto")
    return DTYPES[str(args["dtype"])]


def apply_dtype_gate(dtype, state, overrides, *, length: int,
                     device: DeviceLike = None, **pipe_kwargs):
    """With ``dtype="auto"``, probe bf16-vs-f32 decode agreement on
    echo-bearing waveforms (``serve.probe_dtype_agreement``) and serve
    bf16 (None, the pipeline's default) when it reaches 0.99, else f32
    with a note on stderr. An explicit dtype passes through."""
    if dtype != "auto":
        return dtype
    agree = probe_dtype_agreement(state, overrides, length=length,
                                  device=device, **pipe_kwargs)
    if agree >= AGREE_MIN:
        print(f"dtype gate: bf16 OK (bf16-vs-f32 decode agreement "
              f"{agree:.4f} >= {AGREE_MIN})", file=sys.stderr)
        return None
    print(f"dtype gate FIRED: bf16-vs-f32 decode agreement {agree:.4f} "
          f"< {AGREE_MIN} on echo-bearing waveforms -> serving float32. "
          f"Pass dtype=bfloat16 to override.", file=sys.stderr)
    return torch.float32


def load_calib(args: Dict[str, Any]) -> Optional[np.ndarray]:
    """``int8_calib=<.npy>`` -> (B, 1, L) f32 calibration batch or None."""
    if not args.get("int8_calib"):
        return None
    calib = np.load(str(args["int8_calib"])).astype(np.float32)
    if calib.ndim != 3 or calib.shape[1] != 1:
        raise SystemExit(f"int8_calib must be a (B, 1, L) array, got "
                         f"{calib.shape}")
    return calib


def load_stack_cfg(args: Dict[str, Any]) -> Dict[str, Any]:
    """``int8_stack=4,8,10`` (or ``[4,8,10]``) + ``int8_eq_alpha=`` +
    ``int8_bias_correct=`` -> the stack arguments of make_pipeline."""
    raw = args.get("int8_stack")
    if raw in (None, ""):
        layers = None
    elif isinstance(raw, (list, tuple)):
        layers = tuple(int(i) for i in raw)
    else:
        layers = tuple(int(t) for t in str(raw).split(","))
    if layers and not args.get("int8_calib"):
        raise SystemExit("int8_stack= requires int8_calib= (the stack "
                         "scales are calibrated)")
    alpha = args.get("int8_eq_alpha")
    return {
        "int8_stack_layers": layers,
        "int8_eq_alpha": None if alpha in (None, "Null") else float(alpha),
        "int8_bias_correct": bool(args.get("int8_bias_correct", False)),
    }


def main(argv: Optional[List[str]] = None) -> str:
    """Export one artifact from ``key=value`` arguments; returns its path
    and prints a summary line on stderr."""
    args = parse_args(argv)
    unknown = set(args) - _KNOWN_KEYS
    if unknown:
        raise SystemExit(f"unknown argument(s) {sorted(unknown)}; "
                         f"supported: {sorted(_KNOWN_KEYS)}")
    if args.get("platforms"):
        raise SystemExit("platforms= is not taken: an artifact of the "
                         "port serves on devices of the kind it was "
                         "exported for; name it with device= (cuda, the "
                         "default, or cpu)")
    model = str(args.get("model") or "stofnet").lower()
    if not args.get("model_file") and model != "gradpeak":
        raise SystemExit("model_file=<ckpt prefix or path> is required")
    dtype = resolve_dtype(args)
    out = args.get("out") or f"{args.get('model_file') or model}.pt2"
    device = resolve_device(args.get("device"))
    if model == "stofnet":
        state, overrides = resolve_variables_and_overrides(args)
    else:
        if any(args.get(k) for k in INT8_KEYS):
            raise SystemExit("int8 export targets model=stofnet only")
        state, overrides = resolve_zoo_variables_and_overrides(args, model)
    th = args.get("th")
    length = int(args.get("length", 8000))
    pipe_kwargs = dict(
        window_size=int(args.get("window_size", 20)),
        threshold=None if th in (None, "Null") else float(th),
        max_echoes=int(args.get("max_echoes", 64)),
        int8_calib=load_calib(args), **load_stack_cfg(args))
    dtype = apply_dtype_gate(dtype, state, overrides, length=length,
                             model_name=model, device=device, **pipe_kwargs)
    # batch=b (any name that is not a number) exports one batch-polymorphic
    # program; an int pins the batch
    batch = args.get("batch", 128)
    batch = (str(batch) if isinstance(batch, str)
             and not str(batch).isdigit() else int(batch))
    pipe_kwargs.update(dtype=dtype, model_name=model)
    if args.get("input_enc") not in (None, "", "f32"):
        # after the dtype gate, as in JAX: the gate probes the compute type
        # on the f32-input pipeline; the input encoding is another choice
        pipe_kwargs["input_enc"] = str(args["input_enc"])
    if args.get("bake_weights", True):
        artifact = export_pipeline(state, overrides, batch, length,
                                   device=device, **pipe_kwargs)
        weights, note = None, "weights baked in"
    else:
        artifact, weights = export_pipeline_weightless(
            state, overrides, batch, length, device=device, **pipe_kwargs)
        note = f"weights as inputs + {out}.weights.npz sidecar"
    path = save_pipeline(out, artifact, weights=weights)
    enc = pipe_kwargs.get("input_enc", "f32")
    print(f"exported {path} ({path.stat().st_size / 1e6:.2f} MB, "
          f"model={model}, device={device}, "
          f"input=({batch}, 1, {length}) {enc}"
          + (" [encoded input: codes ride the host-to-device copy]"
             if enc != "f32" else "") + f", {note})", file=sys.stderr)
    return str(path)


if __name__ == "__main__":
    main()
