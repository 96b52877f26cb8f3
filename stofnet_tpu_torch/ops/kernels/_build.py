"""Build the CUDA kernels in ``stofnet_tpu_torch/csrc`` and load them (no
JAX counterpart: the Pallas kernels compile inside ``jax.jit``).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``build/kernels/lib<name>.so`` at the repository root (a gitignored
directory) the first time it is needed, and loaded with ``ctypes``. A
source exports a plain C interface: every launch function takes raw device
pointers, then the device index and the CUDA stream (``launch_args``),
launches on that stream, and returns ``cudaGetLastError()`` so that a
refused launch is reported to the caller.

A library is rebuilt when its source or a shared ``csrc/*.cuh`` header is
newer than it. ``build_all``
starts one ``nvcc`` per source at once and waits for all of them.

The builds and the loads are set-up stages of the program's spans
(``utils/profiling.once``): ``kernels.build`` around the compilers,
``kernels.load`` around a library's first load (its build included).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import torch

from stofnet_tpu_torch.utils import profiling

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# the current stream's raw handle as an int, where the installed torch has it
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)"
                       ": the CUDA kernels are built from source at first use")


def _paths(name: str):
    return CSRC / f"{name}.cu", BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """No library yet, or one older than its source or a shared header."""
    src, lib = _paths(name)
    if not lib.is_file():
        return True
    newest = max(p.stat().st_mtime for p in [src, *CSRC.glob("*.cuh")])
    return lib.stat().st_mtime < newest


def build_all(names: Sequence[str]) -> Dict[str, str]:
    """Compile every stale source of ``names`` in parallel; returns the
    compiler's output (register and shared-memory use) by name. The
    library is written under a temporary name and renamed into place, so a
    build that fails leaves no half-written library behind."""
    with _lock:
        todo = [n for n in names if _stale(n)]
        if not todo:
            return {}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        procs = []
        with profiling.once("kernels.build"):
            for n in todo:
                src, lib = _paths(n)
                tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
                procs.append((n, tmp, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            logs, failed = {}, []
            # wait for every compiler before raising
            for n, tmp, proc in procs:
                logs[n], _ = proc.communicate()
                if proc.returncode != 0:
                    failed.append(f"nvcc failed on {n}.cu "
                                  f"(rc={proc.returncode}):\n{logs[n]}")
                    continue
                os.replace(tmp, _paths(n)[1])
        if failed:
            raise RuntimeError("\n".join(failed))
        return logs


def load(name: str, functions: Dict[str, List]) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed, load it and declare the C
    signatures: ``functions`` maps each symbol to its ``argtypes``; every
    launch function returns an int (a ``cudaError_t``)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with profiling.once("kernels.load"):
        build_all([name])
        lib = ctypes.CDLL(str(_paths(name)[1]))
        for fn, argtypes in functions.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
    _libs[name] = lib
    return lib


def launch_args(t: torch.Tensor) -> Tuple[int, int]:
    """The last two arguments of every launch function for the CUDA tensor
    ``t``: its device index and the raw handle of that device's current
    stream. Builds no ``torch.cuda.Stream`` object where torch gives the
    handle as an int."""
    index = t.get_device()
    if _raw_stream is not None:
        return index, _raw_stream(index)
    return index, torch.cuda.current_stream(index).cuda_stream


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a launch function reported a CUDA error."""
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
