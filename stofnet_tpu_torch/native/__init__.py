"""Native (C++) ASCII loader, through ctypes (replaces
``stofnet_tpu/native``; its own copy of ``fastloader.cpp``).

:func:`loadtxt` reads the 1- and 2-column numeric text files of the chirp
dataset (``np.loadtxt`` semantics for those shapes, commas accepted). The
library is built with ``g++ -O3`` the first time it is needed, into
``build/native/`` at the repository root (a gitignored directory), and
rebuilt when the source is newer. Where no compiler is found, everything
runs the pure-python parser, which has the same semantics, the loud
ValueError on a corrupt token included.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "fastloader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_LIB = BUILD_DIR / "libfastloader.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    """Compile the library under a temporary name and rename it into
    place, so a build that fails, or one racing another process, leaves no
    half-written library."""
    tmp = _LIB.with_name(f"{_LIB.name}.{os.getpid()}.tmp")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", str(_SRC),
                        "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        stale = (_LIB.exists()
                 and _SRC.stat().st_mtime > _LIB.stat().st_mtime)
        if (not _LIB.exists() or stale) and not _build():
            return None
        try:
            lib = ctypes.CDLL(str(_LIB))
        except OSError:
            return None
        lib.fastload_floats.restype = ctypes.c_long
        lib.fastload_floats.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
            ctypes.c_long, ctypes.POINTER(ctypes.c_long)]
        lib.fastload_filesize.restype = ctypes.c_long
        lib.fastload_filesize.argtypes = [ctypes.c_char_p]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether :func:`loadtxt` runs the C++ parser (built, or buildable)."""
    return get_lib() is not None


def _py_loadtxt(path) -> np.ndarray:
    """Pure-python parser with the same semantics as the C one:
    whitespace or comma separated, '#' comments stripped, column count
    from the first numeric line, (n,) for one column / (n, c) otherwise,
    and a ValueError naming the line on an unparseable token (dropping
    one would shift every later value)."""
    vals: list = []
    ncols = 0
    with open(path, encoding="utf-8-sig") as f:  # tolerate a BOM like C
        for lineno, line in enumerate(f, 1):
            line = line.split("#", 1)[0].replace(",", " ")
            nums = []
            for tok in line.split():
                # python float() accepts '1_0' (10.0), which the C strtod
                # sweep flags: reject it so both paths agree on corruption
                try:
                    if "_" in tok:
                        raise ValueError
                    nums.append(float(tok))
                except ValueError:
                    raise ValueError(
                        f"{path}: line {lineno}: unparseable numeric "
                        f"token {tok!r}") from None
            if not nums:
                continue
            if ncols == 0:
                ncols = len(nums)
            vals.extend(nums)
    arr = np.asarray(vals, dtype=np.float64)
    if ncols <= 1:
        return arr
    return arr.reshape(-1, ncols)


def loadtxt(path) -> np.ndarray:
    """np.loadtxt equivalent for whitespace/comma-separated numeric files
    ((n,) for one column, (n, c) otherwise)."""
    lib = get_lib()
    if lib is None:
        return _py_loadtxt(path)
    bpath = str(path).encode()
    size = lib.fastload_filesize(bpath)
    if size < 0:
        raise FileNotFoundError(path)
    cap = max(size // 2 + 16, 64)  # >= one value per 2 bytes is impossible
    out = np.empty(cap, dtype=np.float64)
    ncols = ctypes.c_long(0)
    n = lib.fastload_floats(
        bpath, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        cap, ctypes.byref(ncols))
    if n == -2:
        # corrupt content: the python parser raises on the same inputs and
        # names the line and token
        return _py_loadtxt(path)
    if n < 0:
        raise IOError(f"fastloader failed on {path}")
    vals = out[:n]
    c = max(int(ncols.value), 1)
    if c == 1:
        return vals.copy()
    return vals.reshape(-1, c).copy()
