"""Weights between the JAX package's flax trees, reference ``.pth`` files and
the port (replaces ``stofnet_tpu/models/torch_import.py``: its own copy of
``params_to_state_dict``, ``save_torch_state_dict`` and of the StofNet
architecture inference of ``import_stofnet``).

Key mapping is structural: a flax ``params[a][b]['kernel']`` of shape
(K, I, O) is torch ``a.b.weight`` (O, I, K); ``bias`` copies through.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def params_to_state_dict(
    variables: Dict[str, Any],
    batchnorm_modules: Tuple[str, ...] = (),
) -> Dict[str, np.ndarray]:
    """flax variables (any array type numpy can read) -> torch-name state
    dict of numpy arrays in torch layout."""
    sd: Dict[str, np.ndarray] = {}

    def is_bn(mod: str) -> bool:
        return any(mod == b or mod.startswith(b + ".")
                   for b in batchnorm_modules)

    for (*scope, leaf), val in _flatten(variables.get("params", {})):
        val = np.asarray(val)
        mod = ".".join(scope)
        if is_bn(mod):
            sd[f"{mod}.{'weight' if leaf == 'scale' else 'bias'}"] = val
        elif leaf == "kernel":
            if val.ndim == 3:  # (K, I, O) -> Conv1d (O, I, K)
                sd[f"{mod}.weight"] = np.transpose(val, (2, 1, 0))
            elif val.ndim == 2:  # (I, O) -> Linear (O, I)
                sd[f"{mod}.weight"] = np.transpose(val, (1, 0))
            else:
                sd[f"{mod}.weight"] = val
        else:  # raw named parameters
            sd[f"{mod}.{leaf}"] = val
    for (*scope, leaf), val in _flatten(variables.get("batch_stats", {})):
        mod = ".".join(scope)
        name = "running_mean" if leaf == "mean" else "running_var"
        sd[f"{mod}.{name}"] = np.asarray(val)
        sd.setdefault(f"{mod}.num_batches_tracked", np.asarray(0))
    return sd


def save_torch_state_dict(sd: Dict[str, Any], path: str) -> None:
    """Write a state dict (tensors or arrays, reference names) as a
    ``.pth`` that the reference's ``torch.load`` reads: f32 tensors on the
    CPU, 0-d entries as int tensors."""
    out = {}
    for k, v in sd.items():
        a = np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor)
                       else v)
        out[k] = (torch.from_numpy(np.array(a, np.float32, copy=True))
                  if a.ndim else torch.tensor(int(a)))
    torch.save(out, path)


def stofnet_overrides(sd: Dict[str, Any]) -> Dict[str, Any]:
    """The StofNet architecture of a state dict, from its tensor shapes:
    ``upsample_factor`` always, the other constructor arguments only where
    they differ from the defaults. ``semi_global_scale`` is the contract
    conv's width / num_features * 10 (the reference's
    ``feat_scale = max(1, scale // 10)``); no SGB tensors means 1."""
    o_last = int(sd["conv_last.weight"].shape[0])
    k_last = int(sd["conv_last.weight"].shape[-1])
    o1, in_ch, k1 = (int(s) for s in sd["conv1.weight"].shape)
    conv_ids = [int(k[4:].split(".")[0]) for k in sd
                if k.startswith("conv") and k.endswith(".weight")
                and k[4:].split(".")[0].isdigit()]
    num_blocks = max(conv_ids) + 1
    k_mid = int(sd["conv2.weight"].shape[-1]) if "conv2.weight" in sd else 7

    overrides: Dict[str, Any] = {"upsample_factor": o_last}
    if in_ch != 1:
        overrides["in_channels"] = in_ch
    if o1 != 64:
        overrides["num_features"] = o1
    if num_blocks != 13:
        overrides["num_blocks"] = num_blocks
    if [k1, k_mid, k_last] != [9, 7, 3]:
        overrides["kernel_sizes"] = [k1, k_mid, k_last]
    if "semi_global_block.contract_conv.weight" not in sd:
        overrides["semi_global_scale"] = 1
    else:
        feat = int(sd["semi_global_block.contract_conv.weight"].shape[0])
        scale = max(feat // o1, 1) * 10
        if scale != 80:
            overrides["semi_global_scale"] = scale
    return overrides


def load_stofnet(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """Load a reference StofNet ``.pth``; returns (state dict, overrides)
    with the architecture inferred from the tensor shapes (see
    :func:`stofnet_overrides`). Tensors stay on the CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k: v.detach() for k, v in sd.items()}
    return sd, stofnet_overrides(sd)
