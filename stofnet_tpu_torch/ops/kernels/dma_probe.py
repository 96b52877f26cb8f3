"""The streaming-read probe and its canary (replaces the two kernels of
``scripts/dma_probe.py``: ``make_manual_probe(...).probe`` and ``triv``).

``stream_probe(x, chunk_rows, n_buffers)`` sums a (n_rows, 128) bf16 array
to out[r, c] = sum_i x[8 i + r, c] in f32; on a CUDA tensor it launches the
CUDA kernel ``csrc/dma_probe.cu``, which streams the input through an
``n_buffers``-stage ring of ``chunk_rows``-row stages in each CTA's shared
memory; on a CPU tensor it runs ``stream_probe_reference``, which walks the
chunks as the TPU kernel does. ``canary(x)`` is o = 2 x, the check that the
build and launch route works. Their designs and bounds are in the source's
header; ``scripts/dma_probe.py`` sweeps and times the probe.
"""

from __future__ import annotations

import ctypes

import torch

from stofnet_tpu_torch.ops.kernels import _build

WIDTH = 128  # columns of the probe's input
GROUP = 8  # rows summed apart: out[r] takes rows r, r + 8, ...
N_BUFFERS = (2, 3, 4, 6, 8)  # ring depths the kernel is built for

# kernel launches since the last reset (chip_smoke.py reads them)
probe_launches = 0
canary_launches = 0
COUNTERS = ("probe_launches", "canary_launches")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURE = {
    "dma_probe_ctas": [_LL, _I, _I, _I, ctypes.POINTER(_I)],
    "dma_probe_launch": [_P, _P, _P, _LL, _I, _I, _I, _I, _P],
    "dma_canary_launch": [_P, _P, _I, _I, _P],
}


def stream_probe_reference(x: torch.Tensor, chunk_rows: int) -> torch.Tensor:
    """Plain version: (8, 128) f32, chunk by chunk as the TPU kernel adds
    them, ``acc += chunk.float().reshape(-1, 8, 128).sum(0)``."""
    acc = torch.zeros((GROUP, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    for chunk in x.split(chunk_rows):
        acc += chunk.float().reshape(-1, GROUP, x.shape[1]).sum(0)
    return acc


def stream_probe(x: torch.Tensor, chunk_rows: int,
                 n_buffers: int = 2) -> torch.Tensor:
    """out[r, c] = sum_i x[8 i + r, c] in f32, (n_rows, 128) -> (8, 128).

    ``chunk_rows`` is the rows of one stage of a CTA's ring and
    ``n_buffers`` the ring's depth (2, 3, 4, 6 or 8). The CUDA kernel on a
    CUDA tensor (bfloat16; a stage size and depth that shared memory
    cannot hold raise), the plain version on a CPU tensor. The kernel sums
    in a fixed order: two calls on one card give the same bits."""
    global probe_launches
    if x.ndim != 2 or x.shape[1] != WIDTH:
        raise ValueError(f"stream_probe: x {tuple(x.shape)}: needs "
                         f"(n_rows, {WIDTH})")
    if chunk_rows <= 0 or chunk_rows % GROUP or x.shape[0] % chunk_rows:
        raise ValueError(f"stream_probe: chunk_rows={chunk_rows}: needs a "
                         f"positive multiple of {GROUP} that divides "
                         f"n_rows={x.shape[0]}")
    if n_buffers not in N_BUFFERS:
        raise ValueError(f"stream_probe: n_buffers={n_buffers}, not one of "
                         f"{N_BUFFERS}")
    if x.device.type == "cpu":
        return stream_probe_reference(x, chunk_rows)
    if x.device.type != "cuda" or x.dtype != torch.bfloat16:
        raise TypeError(f"stream_probe: the CUDA kernel takes bfloat16 on a "
                        f"CUDA device, got {x.dtype} on {x.device}")
    x = x.contiguous()
    dev = x.get_device()
    lib = _build.load("dma_probe", _SIGNATURE)
    ctas = ctypes.c_int(0)
    err = lib.dma_probe_ctas(x.shape[0] // chunk_rows, chunk_rows, n_buffers,
                             dev, ctypes.byref(ctas))
    _build.check(lib, err, f"stream_probe (chunk_rows={chunk_rows}, "
                           f"n_buffers={n_buffers})")
    partial = torch.empty((ctas.value, GROUP, WIDTH), dtype=torch.float32,
                          device=x.device)
    out = torch.empty((GROUP, WIDTH), dtype=torch.float32, device=x.device)
    err = lib.dma_probe_launch(
        x.data_ptr(), partial.data_ptr(), out.data_ptr(), x.shape[0],
        chunk_rows, n_buffers, ctas.value, *_build.launch_args(x))
    _build.check(lib, err, "stream_probe")
    probe_launches += 1
    return out


def canary_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the canary: ``x * 2``."""
    return x * 2


def canary(x: torch.Tensor) -> torch.Tensor:
    """o = 2 x, equal bit for bit to ``x * 2``: the CUDA kernel on a CUDA
    tensor (float32), the plain version on a CPU tensor."""
    global canary_launches
    if x.device.type == "cpu":
        return canary_reference(x)
    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise TypeError(f"canary: the CUDA kernel takes float32 on a CUDA "
                        f"device, got {x.dtype} on {x.device}")
    x = x.contiguous()
    out = torch.empty_like(x)
    lib = _build.load("dma_probe", _SIGNATURE)
    err = lib.dma_canary_launch(
        x.data_ptr(), out.data_ptr(), x.numel(), *_build.launch_args(x))
    _build.check(lib, err, "canary")
    canary_launches += 1
    return out
