"""The model registry: the config's ``model=`` name to a module, and the
zoo's checkpoints (replaces ``stofnet_tpu/models/registry.py``).

``build_model`` returns (module, config updates), the updates being the
reference driver's overrides (``main.py:133-167``): sincnet sets
``upsample_factor`` 1, unet folds the upsample factor into
``rf_scale_factor`` and sets it to 1, gradpeak sets ``evaluate``.

Every module carries the reference's torch parameter names, so a
reference ``.pth`` (or the JAX package's ``export_checkpoint`` output)
loads with ``load_state_dict(strict=True)``, and a module's
``state_dict()`` is what ``export_checkpoint`` writes.
:func:`variables_to_state_dict` carries JAX variables (numpy arrays) over.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from stofnet_tpu_torch import DeviceLike
from stofnet_tpu_torch.models import (
    edsr1d, kuleshov as _kuleshov, sincnet as _sincnet, wave_unet, zonzini,
)
from stofnet_tpu_torch.models.edsr1d import EDSR1D
from stofnet_tpu_torch.models.espcn1d import ESPCN1D
from stofnet_tpu_torch.models.gradpeak import GradPeak
from stofnet_tpu_torch.models.kuleshov import Kuleshov
from stofnet_tpu_torch.models.sincnet import SincNet
from stofnet_tpu_torch.models.stofnet import StofNet
from stofnet_tpu_torch.models.torch_import import (
    load_stofnet, params_to_state_dict, save_torch_state_dict,
)
from stofnet_tpu_torch.models.wave_unet import WaveUnet
from stofnet_tpu_torch.models.zonzini import ZonziniNetLarge, ZonziniNetSmall

MODEL_NAMES = ("stofnet", "zonzini", "kuleshov", "edsr", "espcn", "sincnet",
               "unet", "gradpeak")
# the families whose output is the ToA itself, not a heatmap
REGRESSION = ("zonzini", "gradpeak")


def build_model(name: str, dataset_kind: str = "chirp",
                upsample_factor: int = 4, sample_num: Optional[int] = None,
                rf_scale_factor: int = 10, fs: Optional[float] = None,
                th: Optional[float] = None,
                dtype: Optional[torch.dtype] = None,
                semi_global_scale: int = 80, n_layers: Optional[int] = None,
                generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Tuple[nn.Module, Dict[str, Any]]:
    """The ``name`` model for a dataset kind ("chirp", "pala" or "rat"),
    fresh: drawn from ``generator`` on the CPU (torch's default generator
    when None), then moved to ``device`` (the card when None). On the meta
    device it has no data. ``n_layers`` is the unet's depth, 2 on chirp
    and 10 elsewhere when None."""
    name = name.lower()
    chirp = dataset_kind == "chirp"
    updates: Dict[str, Any] = {}
    kw = dict(dtype=dtype, generator=generator, device=device)
    if name == "stofnet":
        return StofNet(upsample_factor=upsample_factor,
                       semi_global_scale=semi_global_scale, **kw), updates
    if name == "zonzini":
        cls = ZonziniNetSmall if chirp else ZonziniNetLarge
        return cls(**kw), updates
    if name == "kuleshov":
        n = sample_num * rf_scale_factor
        return Kuleshov(input_length=n, output_length=n * upsample_factor,
                        **kw), updates
    if name == "edsr":
        return EDSR1D(upscale_factor=upsample_factor, **kw), updates
    if name == "espcn":
        return ESPCN1D(upscale_factor=upsample_factor, **kw), updates
    if name == "sincnet":
        updates["upsample_factor"] = 1  # main.py:144
        return SincNet(sample_rate=float(fs) * rf_scale_factor, **kw), updates
    if name == "unet":
        # the driver folds the upsampling into the input's interpolation
        updates["rf_scale_factor"] = rf_scale_factor * upsample_factor
        updates["upsample_factor"] = 1
        if n_layers is None:
            n_layers = 2 if chirp else 10
        return WaveUnet(n_layers=int(n_layers), channels_interval=16,
                        **kw), updates
    if name == "gradpeak":
        updates["evaluate"] = True  # main.py:165
        return GradPeak(threshold=th, rescale_factor=rf_scale_factor,
                        echo_max=1 if chirp else None, onset_opt=chirp,
                        device=device), updates
    raise ValueError(f"unknown model '{name}' (known: {MODEL_NAMES})")


def _interop_spec(name: str, n_layers: int = 2):
    """(flax -> torch key rewrite, flax BatchNorm modules) of a family."""
    return {
        "edsr": (edsr1d.rewrite_flax_key, ()),
        "zonzini": (zonzini.rewrite_flax_key, ()),
        "sincnet": (_sincnet.rewrite_flax_key, _sincnet.BATCHNORM_MODULES),
        "unet": (wave_unet.rewrite_flax_key,
                 wave_unet.batchnorm_modules(n_layers)),
        "kuleshov": (None, _kuleshov.BATCHNORM_MODULES),
    }.get(name.lower(), (None, ()))


def variables_to_state_dict(name: str, variables: Mapping[str, Any],
                            n_layers: int = 2) -> Dict[str, np.ndarray]:
    """JAX variables of family ``name`` (arrays numpy can read) -> the
    reference's torch state dict of numpy arrays: ``params_to_state_dict``
    with the family's BatchNorm modules, then its key rewrite."""
    rewrite, bn = _interop_spec(name, n_layers)
    sd = params_to_state_dict(dict(variables), batchnorm_modules=bn)
    if rewrite is not None:
        sd = {rewrite(k): v for k, v in sd.items()}
    return sd


def import_checkpoint(name: str, path: str | Path,
                      n_layers: int = 2) -> Dict[str, torch.Tensor]:
    """A reference ``.pth`` of family ``name`` as a state dict of CPU
    tensors under the module's names (StofNet's through ``load_stofnet``).
    For the unet, ``n_layers`` is held against the file's encoder depth."""
    name = name.lower()
    if name == "stofnet":
        return load_stofnet(str(path))[0]
    sd = torch.load(str(path), map_location="cpu", weights_only=True)
    sd = {k: v.detach() for k, v in sd.items()}
    if name == "unet":
        depth = len({k.split(".")[1] for k in sd if k.startswith("encoder.")})
        if depth != n_layers:
            raise ValueError(f"{path}: a Wave-U-Net of {depth} layers, "
                             f"not n_layers={n_layers}")
    return sd


def export_checkpoint(name: str, state: Mapping[str, Any],
                      path: str | Path) -> str:
    """Write a module's state dict as a ``.pth`` the reference's
    ``torch.load`` reads (``save_torch_state_dict``); GradPeak has
    nothing to write."""
    if name.lower() == "gradpeak":
        raise ValueError("gradpeak has no parameters to export")
    save_torch_state_dict(dict(state), str(path))
    return str(path)
