"""Checkpoint I/O (replaces ``stofnet_tpu/train/checkpoint.py``): the whole
training state in one ``torch.save`` file, for mid-run resume, and the
import of reference StofNet ``.pth`` files.

A checkpoint holds ``model`` (name -> tensor), ``optimizer`` and
``scheduler`` (their ``state_dict``s) and ``step``; it loads with
``torch.load(weights_only=True)``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import torch

from stofnet_tpu_torch.models.torch_import import load_stofnet


def save_checkpoint(path: str | Path, params: Mapping[str, torch.Tensor],
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    scheduler=None, step: int = 0) -> Path:
    """Write the training state to ``path``; returns its absolute path."""
    path = Path(path).absolute()
    torch.save({
        "model": {k: v.detach() for k, v in params.items()},
        "optimizer": None if optimizer is None else optimizer.state_dict(),
        "scheduler": None if scheduler is None else scheduler.state_dict(),
        "step": int(step),
    }, path)
    return path


def load_checkpoint(path: str | Path,
                    params: Optional[Mapping[str, torch.Tensor]] = None,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    scheduler=None) -> Dict[str, Any]:
    """Read a checkpoint of :func:`save_checkpoint` (tensors on the CPU)
    and, for each of ``params`` (copied in place: parameters or a
    ``state_dict()``), ``optimizer`` and ``scheduler`` that is given,
    restore it. Returns the checkpoint."""
    ckpt = torch.load(Path(path), map_location="cpu", weights_only=True)
    if params is not None:
        with torch.no_grad():
            for k, v in params.items():
                v.copy_(ckpt["model"][k])
    if optimizer is not None:
        optimizer.load_state_dict(ckpt["optimizer"])
    if scheduler is not None:
        scheduler.load_state_dict(ckpt["scheduler"])
    return ckpt


def find_checkpoint(ckpt_dir: str | Path, model_file: str) -> Optional[Path]:
    """Prefix-match ``model_file`` against ckpt_dir entries.

    Two passes: first the FULL ``model_file`` string (so array-member
    checkpoints sharing a run-name first token — ``{run}_seed3008`` vs
    ``{run}_seed3009`` — stay addressable), then the reference's
    first-token-before-``_`` prefix.
    """
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.is_dir():
        return None
    entries = sorted(ckpt_dir.iterdir())
    for prefix in (str(model_file), str(model_file).split("_")[0]):
        for fn in entries:
            if fn.name.startswith(prefix):
                return fn
    return None


def load_model_variables(model_name: str,
                         path: str | Path) -> Dict[str, torch.Tensor]:
    """A model's state dict from a reference ``.pth`` (StofNet, through
    ``load_stofnet``) or from a checkpoint of :func:`save_checkpoint`."""
    path = Path(path)
    if path.is_file() and path.suffix == ".pth":
        if model_name.lower() != "stofnet":
            raise ValueError(f"the port imports reference .pth files of "
                             f"StofNet only, not {model_name!r}")
        return load_stofnet(str(path))[0]
    return load_checkpoint(path)["model"]
