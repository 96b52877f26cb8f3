"""The helpers the serving daemon shares with the exporter (replaces
``stofnet_tpu/cli/export.py:50-268``; the exporter's ``main``, which writes
``torch.export`` artifacts, comes with the export slice).

Arguments are ``key=value`` pairs, each value parsed as the JAX package's
``yaml.safe_load`` parses it (``utils/config.parse_value``; no PyYAML).
"""

from __future__ import annotations

import sys
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from stofnet_tpu_torch import DeviceLike
from stofnet_tpu_torch.bench_paths import AGREE_MIN
from stofnet_tpu_torch.models.torch_import import stofnet_overrides
from stofnet_tpu_torch.serve import probe_dtype_agreement
from stofnet_tpu_torch.train.checkpoint import (
    find_checkpoint, load_model_variables,
)
from stofnet_tpu_torch.utils.config import parse_value

ARCH_KEYS = ("num_features", "semi_global_scale", "num_blocks",
             "upsample_factor")
DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
          "float32": torch.float32, "f32": torch.float32}


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
