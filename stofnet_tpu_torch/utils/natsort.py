"""Natural (human) sorting for dataset file ordering (the port's own copy
of ``stofnet_tpu/utils/natsort.py``)."""

from __future__ import annotations

import re
from typing import Iterable, List, TypeVar

T = TypeVar("T")

_CHUNK = re.compile(r"(\d+)")


def natural_key(value) -> tuple:
    # text chunks compare ordinally (case-sensitive), as the natsort
    # library's default: lowercasing would reorder mixed-case names
    parts = _CHUNK.split(str(value))
    return tuple(int(p) if p.isdigit() else p for p in parts)


def natsorted(items: Iterable[T]) -> List[T]:
    return sorted(items, key=natural_key)
