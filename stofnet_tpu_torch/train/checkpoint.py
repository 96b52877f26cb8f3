"""Checkpoint I/O (replaces ``stofnet_tpu/train/checkpoint.py``): the whole
training state in one ``torch.save`` file, for mid-run resume, and the
import of reference ``.pth`` files of every family of the registry.

A checkpoint holds ``model`` (name -> tensor), ``optimizer`` and
``scheduler`` (their ``state_dict``s), ``step`` and ``epoch`` (the epochs
run, where ``cli/main.py``'s ``resume=`` starts); it loads with
``torch.load(weights_only=True)``. A file written before ``epoch`` was
stored loads with ``epoch`` 0.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import torch

from stofnet_tpu_torch.models.registry import import_checkpoint


def save_checkpoint(path: str | Path, params: Mapping[str, torch.Tensor],
                    optimizer=None,
                    scheduler=None, step: int = 0, epoch: int = 0) -> Path:
    """Write the training state to ``path``; returns its absolute path.
    ``optimizer`` and ``scheduler`` are objects or their ``state_dict``s
    (a job array's member: ``parallel/array.member_optimizer_state``)."""
    def state(obj):
        return (None if obj is None else obj if isinstance(obj, Mapping)
                else obj.state_dict())

    path = Path(path).absolute()
    torch.save({
        "model": {k: v.detach() for k, v in params.items()},
        "optimizer": state(optimizer),
        "scheduler": state(scheduler),
        "step": int(step),
        "epoch": int(epoch),
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
    ckpt.setdefault("epoch", 0)
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


def load_model_variables(model_name: str, path: str | Path,
                         n_layers: int = 2) -> Dict[str, torch.Tensor]:
    """A model's state dict from a reference ``.pth`` of family
    ``model_name`` (``registry.import_checkpoint``; ``n_layers``, the
    unet's depth) or from a checkpoint of :func:`save_checkpoint`."""
    path = Path(path)
    if path.is_file() and path.suffix == ".pth":
        return import_checkpoint(model_name, path, n_layers)
    # mapped, so that only the model's bytes are read: the file also holds
    # AdamW's two moments, twice the model (15 GB for Kuleshov's)
    ckpt = torch.load(path, map_location="cpu", weights_only=True,
                      mmap=True)
    return {k: v.clone() for k, v in ckpt["model"].items()}
