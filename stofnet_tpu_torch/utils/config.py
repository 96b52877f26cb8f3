"""``key=value`` command-line values (the part of
``stofnet_tpu/utils/config.py`` the port's CLIs need), without PyYAML.

The JAX package parses each value with ``yaml.safe_load``. The machine
with the card has no PyYAML, so :func:`parse_value` resolves the values
the CLIs take as PyYAML's YAML 1.1 resolver does: ``null``/``Null``/``~``
-> None, ``True``/``yes``/``on`` (and their other spellings) -> bool,
decimal ints and octal ones (a leading zero) with underscores, floats
with a dot (``1.0e-3``; ``1e-3`` stays a string, as in YAML 1.1), quoted
strings, and flow lists ``[4, 8, 10]`` of those. Anything else is the
string itself (``4,8,10``, ``s8c16``, ``x.npy``).
"""

from __future__ import annotations

import re
from typing import Any, List

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)")
_FLOAT = re.compile(r"""[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9_]+(?:[eE][-+][0-9]+)?""", re.X)


def _int(text: str) -> int:
    t = text.replace("_", "")
    body = t.lstrip("+-")
    if len(body) > 1 and body.startswith("0"):
        return (-1 if t.startswith("-") else 1) * int(body, 8)
    return int(t)


def _split_flow(body: str) -> List[str]:
    """The items of a flow list's body, split at top-level commas."""
    items, depth, start = [], 0, 0
    for i, ch in enumerate(body):
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        elif ch == "," and depth == 0:
            items.append(body[start:i])
            start = i + 1
    items.append(body[start:])
    return [t.strip() for t in items]


def parse_value(text: str) -> Any:
    """A command-line value as ``yaml.safe_load`` gives it (module
    docstring)."""
    t = text.strip()
    if t in _NULL:
        return None
    if t in _TRUE:
        return True
    if t in _FALSE:
        return False
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "'\"":
        return t[1:-1]
    if t.startswith("[") and t.endswith("]"):
        body = t[1:-1].strip()
        return [parse_value(item) for item in _split_flow(body)] if body \
            else []
    if _INT.fullmatch(t):
        return _int(t)
    if _FLOAT.fullmatch(t):
        return float(t.replace("_", ""))
    return t
