"""Export the serving pipeline to a ``torch.export`` artifact (replaces
``stofnet_tpu/cli/export.py`` for ``model=stofnet``), and the helpers the
serving daemon shares with it::

    python -m stofnet_tpu_torch.cli.export model_file=different-armadillo \
        ckpt_dir=ckpts length=8000 batch=b out=m.pt2 [th=Null] \
        [max_echoes=64] [window_size=20] [dtype=auto|bfloat16|float32] \
        [int8_calib=x.npy [int8_stack=4,8,10] [int8_eq_alpha=0.5]
         [int8_bias_correct=True]] [input_enc=bf16|s16|s8c<n>] \
        [bake_weights=False] [device=cpu]

``batch=b`` (any name) exports one batch-polymorphic program, an int pins
the batch; the length is static: one artifact per length. ``dtype=auto``
(the default) probes bf16 against f32 on echo-bearing waveforms before
the input encoding is applied, as in JAX, and exports f32 where bf16
moves the decode. ``bake_weights=False`` takes the weights as the
program's inputs from a ``<out>.weights.npz`` sidecar. Serve the file
with ``serve.load_pipeline(out)`` or ``cli/serve.py artifact=out``.

Departures from the JAX exporter: ``device=`` (the card by default, as
every entry point of the port) takes the place of ``platforms=``, which
is refused: a program serves on the device it was exported for (the
device chooses the route, ``serve.fused_takes``). ``model=`` other than
stofnet waits for the model zoo's slice.

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

ARCH_KEYS = ("num_features", "semi_global_scale", "num_blocks",
             "upsample_factor")
DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
          "float32": torch.float32, "f32": torch.float32}
_KNOWN_KEYS = frozenset({
    "model_file", "out", "ckpt_dir", "platforms", "th", "batch", "length",
    "window_size", "max_echoes", "int8_calib", "model", "dtype",
    "int8_stack", "int8_eq_alpha", "int8_bias_correct", "bake_weights",
    "input_enc", *ARCH_KEYS,
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
        raise SystemExit("platforms= is not taken: a program of the port "
                         "serves on the device it was exported for; name "
                         "it with device= (cuda, the default, or cpu)")
    model = str(args.get("model") or "stofnet").lower()
    if model != "stofnet":
        raise SystemExit(f"model={model}: the port exports model=stofnet; "
                         f"the model zoo comes with its own slice")
    if not args.get("model_file"):
        raise SystemExit("model_file=<ckpt prefix or path> is required")
    dtype = resolve_dtype(args)
    out = args.get("out") or f"{args['model_file']}.pt2"
    device = resolve_device(args.get("device"))
    state, overrides = resolve_variables_and_overrides(args)
    th = args.get("th")
    length = int(args.get("length", 8000))
    pipe_kwargs = dict(
        window_size=int(args.get("window_size", 20)),
        threshold=None if th in (None, "Null") else float(th),
        max_echoes=int(args.get("max_echoes", 64)),
        int8_calib=load_calib(args), **load_stack_cfg(args))
    dtype = apply_dtype_gate(dtype, state, overrides, length=length,
                             device=device, **pipe_kwargs)
    # batch=b (any name that is not a number) exports one batch-polymorphic
    # program; an int pins the batch
    batch = args.get("batch", 128)
    batch = (str(batch) if isinstance(batch, str)
             and not str(batch).isdigit() else int(batch))
    pipe_kwargs["dtype"] = dtype
    if args.get("input_enc") not in (None, "", "f32"):
        # after the dtype gate, as in JAX: the gate probes the compute type
        # on the f32-input pipeline; the input encoding is another choice
        pipe_kwargs["input_enc"] = str(args["input_enc"])
    if args.get("bake_weights", True):
        program = export_pipeline(state, overrides, batch, length,
                                  device=device, **pipe_kwargs)
        weights, note = None, "weights baked in"
    else:
        program, weights = export_pipeline_weightless(
            state, overrides, batch, length, device=device, **pipe_kwargs)
        note = f"weights as inputs + {out}.weights.npz sidecar"
    path = save_pipeline(out, program, weights=weights)
    enc = pipe_kwargs.get("input_enc", "f32")
    print(f"exported {path} ({path.stat().st_size / 1e6:.2f} MB, "
          f"model={model}, device={device}, "
          f"input=({batch}, 1, {length}) {enc}"
          + (" [encoded input: codes ride the host-to-device copy]"
             if enc != "f32" else "") + f", {note})", file=sys.stderr)
    return str(path)


if __name__ == "__main__":
    main()
