"""PyTorch/CUDA port of stofnet_tpu (replaces ``stofnet_tpu/__init__.py``).

The port runs the StofNet RF->ToF serving path on an NVIDIA Hopper card:
plain PyTorch around two CUDA C++ kernels written for ``sm_90a``
(``ops/kernels``). It imports ``torch`` and never ``jax`` or
``stofnet_tpu``; what it needs of host-only modules it keeps as its own
copies.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card and without that request they raise.
"""

from __future__ import annotations

from typing import Union

import torch

__version__ = "0.1.0"

DeviceLike = Union[str, torch.device, None]


def default_device() -> torch.device:
    """The card. Raises when PyTorch sees no CUDA device: the port never
    falls back to the CPU on its own; pass ``device="cpu"`` for that."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "stofnet_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return torch.device("cuda")


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> :func:`default_device`; anything else as given."""
    return default_device() if device is None else torch.device(device)
