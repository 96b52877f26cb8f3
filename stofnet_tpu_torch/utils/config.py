"""Configuration (replaces ``stofnet_tpu/utils/config.py``): YAML defaults
plus ``key=value`` command-line overrides, without PyYAML.

The JAX package reads its config and the dataset's ``sensor_specs.yaml``
with ``yaml.safe_load`` and parses each command-line value the same way.
The machine with the card has no PyYAML, so:

- :func:`parse_value` resolves the values the CLIs take as PyYAML's YAML
  1.1 resolver does: ``null``/``Null``/``~`` -> None, ``True``/``yes``/
  ``on`` (and their other spellings) -> bool, decimal ints and octal ones
  (a leading zero) with underscores, floats with a dot (``1.0e-3``;
  ``1e-3`` stays a string, as in YAML 1.1), quoted strings, and flow lists
  ``[4, 8, 10]`` of those. Anything else is the string itself
  (``4,8,10``, ``s8c16``, ``x.npy``).
- :func:`read_flat_yaml` reads a flat mapping (``key: value`` lines,
  ``#`` comments, blank lines, flow lists, and block lists of scalars
  under a top-level key, as ``yaml.safe_dump`` writes a list) and refuses
  nesting, naming the line; :func:`dump_flat_yaml` writes one as
  ``yaml.safe_dump`` does for scalars (keys sorted; lists in flow
  style).
- :class:`Config`, :func:`load_config` and :func:`merge_cli` are the JAX
  package's: ``${key}`` interpolation is resolved against the post-merge
  values (an override of a referenced key propagates into dependents), a
  whole-value ``${key}`` keeps the referenced value's type, and chains
  resolve recursively with a cycle guard.
"""

from __future__ import annotations

import math
import re
import sys
from pathlib import Path
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

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


def _strip_comment(line: str) -> str:
    """``line`` up to a ``#`` that starts a comment (at the line's start or
    after a blank, outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def read_flat_yaml(text: str, source: str = "<yaml>") -> Dict[str, Any]:
    """The flat mapping of a YAML document, as ``yaml.safe_load`` reads
    it: one ``key: value`` a line, values through :func:`parse_value`, and
    under a top-level ``key:`` with no value a block list of scalars (the
    ``- item`` lines ``yaml.safe_dump`` writes for a list). Raises
    ValueError, naming the line, on anything else (an indented line that
    is no item, an item under a key that has a value, an item that is a
    mapping or a list, a line without ``key:``): nested mappings are not
    read."""
    out: Dict[str, Any] = {}
    open_key = None  # a key written with no value: its block list follows
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip() or line.strip() in ("---", "..."):
            continue
        item = line.lstrip(" ")
        if open_key is not None and (item == "-" or item.startswith("- ")):
            value = parse_value(item[1:])
            if isinstance(value, list) or re.match(
                    r"^\s*(-(\s|$)|[^'\"\[]*:(\s|$))", item[1:]):
                raise ValueError(f"{source}: line {lineno}: "
                                 f"{raw.strip()!r} is not a scalar item "
                                 f"(nested lists and mappings are not read)")
            if out[open_key] is None:
                out[open_key] = []
            out[open_key].append(value)
            continue
        key, sep, value = line.partition(":")
        if (line[0] in " \t-" or not sep or not key.strip()
                or (value and value[0] not in " \t")):
            raise ValueError(f"{source}: line {lineno}: {raw.strip()!r} is "
                             f"not a flat 'key: value' line or an item of "
                             f"a top-level key's block list (nested "
                             f"mappings are not read)")
        out[key.strip()] = parse_value(value)
        open_key = key.strip() if not value.strip() else None
    return out


def _dump_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_dump_scalar(x) for x in v) + "]"
    text = str(v)
    if parse_value(text) != text or text != text.strip() or any(
            c in text for c in ":#[]{},'\"") or text[:1] in "-?!&*|>%@`":
        return "'" + text.replace("'", "''") + "'"
    return text


def dump_flat_yaml(mapping: Mapping[str, Any]) -> str:
    """``mapping`` (str keys; None, bool, int, float, str values, or flat
    lists of them) as YAML, keys sorted, one ``key: value`` a line. For
    scalars the text is ``yaml.safe_dump``'s; a list is written in flow
    style (``[0, 1]``), which :func:`read_flat_yaml` reads back."""
    return "".join(f"{k}: {_dump_scalar(mapping[k])}\n"
                   for k in sorted(mapping))


_INTERP = re.compile(r"\$\{([^}]+)\}")


class Config(dict):
    """dict with attribute access (cfg.model == cfg['model']).

    Assignments after ``load_config`` are recorded into the raw-template
    overlay too, so a later ``merge_cli`` re-resolve keeps programmatic
    mutations instead of reverting keys that exist in the YAML back to
    their file values. When merge_cli installs the resolved view via
    ``cfg.update``, those writes land in the previous ``_templates`` dict,
    which merge_cli then replaces wholesale with the raw templates: the
    replacement must stay after the update (re-resolution of ``${}``
    depends on templates staying raw).
    """

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __setitem__(self, name: str, value: Any) -> None:
        dict.__setitem__(self, name, value)
        t = self.__dict__.get("_templates")
        if t is not None:
            t[name] = value

    def update(self, *args, **kwargs) -> None:  # type: ignore[override]
        # route through __setitem__ (C-level dict.update would not)
        for k, v in dict(*args, **kwargs).items():
            self[k] = v

    def copy(self) -> "Config":
        c = Config(dict.copy(self))
        object.__setattr__(c, "_templates",
                           dict(getattr(self, "_templates", {})))
        return c


def _resolve(value: Any, root: Dict[str, Any],
             seen: Tuple[str, ...] = ()) -> Any:
    """Resolve ``${key}`` interpolations recursively; a whole-value
    interpolation returns the referenced value's native type."""
    if not isinstance(value, str):
        return value
    whole = _INTERP.fullmatch(value)
    if whole:
        key = whole.group(1)
        if key in root and key not in seen:
            return _resolve(root[key], root, seen + (key,))
        return value

    def sub(m: re.Match) -> str:
        key = m.group(1)
        if key in root and key not in seen:
            return str(_resolve(root[key], root, seen + (key,)))
        return m.group(0)

    return _INTERP.sub(sub, value)


def load_config(path: str | Path) -> Config:
    path = Path(path)
    raw = read_flat_yaml(path.read_text(), str(path))
    cfg = Config({k: _resolve(v, raw) for k, v in raw.items()})
    object.__setattr__(cfg, "_templates", dict(raw))
    return cfg


def merge_cli(cfg: Config, argv: Optional[Iterable[str]] = None) -> Config:
    """Apply ``key=value`` overrides, then re-resolve every interpolation
    from the raw templates (an override of a referenced key propagates
    into dependent values)."""
    args = list(argv) if argv is not None else sys.argv[1:]
    templates = dict(getattr(cfg, "_templates", None) or dict(cfg))
    # keys mutated after load (no template recorded) carry their value over
    for k, v in cfg.items():
        templates.setdefault(k, v)
    for arg in args:
        if "=" not in arg:
            raise ValueError(f"expected key=value, got {arg!r}")
        key, _, val = arg.partition("=")
        templates[key.strip()] = parse_value(val) if val != "" else None
    cfg.clear()
    cfg.update({k: _resolve(v, templates) for k, v in templates.items()})
    object.__setattr__(cfg, "_templates", templates)
    return cfg
