"""Fused SemiGlobalBlock contract path: conv1d(k5, 64->F) + 80x max-pool +
leaky (replaces ``stofnet_tpu/ops/pallas/sgb_kernel.py:sgb_contract_pool``
and ``sgb_contract_pool_trainable``).

Serving: ``sgb_contract_pool`` is the counterpart of JAX's
``sgb_contract_pool``. On a CUDA tensor it lays the weights out in the
image of :func:`sgb_dma_weights` and launches the serving instantiation of
``csrc/sgb_contract_pool_dma.cu`` (the streamed kernel, at every
L % 80 == 0); on a CPU tensor it runs ``sgb_contract_pool_reference`` on
the plain (w, b), at any C. A server lays the image out once and calls
``sgb_contract_pool_prepared`` per batch, whose one launch path is
``sgb_dma.sgb_contract_pool_dma_prepared`` (that module counts the
launches).

Training: ``sgb_contract_pool_trainable`` is differentiable. Its forward
(``sgb_contract_pool_argmax``, kernel A: the streamed kernel's ``wgmma``
loop in ``csrc/sgb_contract_pool_dma.cu`` with an argmax epilogue, on the
weight image of ``sgb_dma_weights``) also returns the int32 offset (0..79)
of each window's first maximal element of the biased f32 conv output, as
the JAX kernel's ``with_argmax``; its backward (``sgb_contract_pool_bwd``,
``csrc/sgb_contract_pool_bwd.cu``) routes the cotangents through those
offsets. It saves (h, pooled, offsets) and the weights. Neither pass
allocates the (B, L, F) pre-pool tensor: only the pooled (B, L/80, F) rows
and their offsets reach device memory. On a CPU tensor both passes run
their plain versions on (w, b), at any C and F: no image is built. The
kernels' designs and bounds are in the sources' headers.

``sgb_dma_weights`` (undone by ``dma_weights_plain``) lives here because
kernel A takes it; ``sgb_dma`` re-exports it for the serving kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from stofnet_tpu_torch.ops.conv import conv1d_same
from stofnet_tpu_torch.ops.kernels import _build
from stofnet_tpu_torch.ops.kernels.conv_stack import tap_block_index

POOL = 80
KSIZE = 5
PAD = KSIZE // 2
CHANNELS = 64
N_TILE = 128  # output channels per CTA (csrc/sgb_contract_pool_dma.cu)
GROUP = 64  # output channels of one tap block of the sgb_dma_weights image
BWD_F_MULT = 64  # kernel B takes F % 64 == 0 (its dh pass's weight chunks)
BWD_RUN = 8  # windows of a dh CTA's run (csrc/sgb_contract_pool_bwd.cu)
BWD_F_TILE = 128  # output channels of a dkernel CTA (the same source)
PLAIN_CHUNK = 8  # channels per pass of the plain backward, as JAX's scan

# kernel launches since the last reset (chip_smoke.py reads them): kernel
# A (forward with argmax), kernel B (backward); sgb_dma counts the serving
# kernel's
argmax_launches = 0
bwd_launches = 0
COUNTERS = ("argmax_launches", "bwd_launches")

_P = ctypes.c_void_p
_I = ctypes.c_int
# csrc/sgb_contract_pool_dma.cu, whichever of this module and sgb_dma loads
# it first: the serving kernel and kernel A
DMA_SIGNATURE = {
    "sgb_contract_pool_dma_launch": [_P, _P, _P, _P, _I, _I, _I,
                                     ctypes.c_float, _I, _P],
    "sgb_contract_pool_argmax_launch": [_P, _P, _P, _P, _P, _I, _I, _I,
                                        ctypes.c_float, _I, _P],
}
_BWD_SIGNATURE = {"sgb_contract_pool_bwd_launch": [
    _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
    ctypes.c_float, _I, _P]}


def sgb_contract_pool_reference(h: torch.Tensor, w: torch.Tensor,
                                b: torch.Tensor,
                                negative_slope: float = 0.01) -> torch.Tensor:
    """Plain version at the kernel's rounding points: weights and bias
    rounded to ``h.dtype``, the conv in f32, max-pool, leaky, then one
    rounding to ``h.dtype``."""
    dt = h.dtype
    y = conv1d_same(h.float(), w.to(dt).float(), b.to(dt).float())
    y = F.max_pool1d(y.transpose(1, 2), POOL)  # (B, F, L/80)
    return F.leaky_relu(y, negative_slope).transpose(1, 2).to(dt)


def sgb_contract_pool_argmax_reference(
        h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
        negative_slope: float = 0.01) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel A: (pooled, offsets). The offsets are those
    of the first maximal element of each window of ``conv(h, w) + b`` in
    f32 (bias included, as the JAX kernel's ``y``), window-relative
    (0..79); pooled is leaky of that maximum, rounded to ``h.dtype``."""
    dt = h.dtype
    y = conv1d_same(h.float(), w.to(dt).float(), b.to(dt).float())
    bsz, length, f = y.shape
    m, off = y.reshape(bsz, length // POOL, POOL, f).max(dim=2)
    return (torch.where(m >= 0, m, negative_slope * m).to(dt),
            off.to(torch.int32))


def sgb_contract_pool_bwd_reference(
        h: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
        pooled: torch.Tensor, off: torch.Tensor,
        negative_slope: float = 0.01
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of kernel B, JAX's chunked formulation
    (``sgb_kernel.py:_trainable_bwd``): (dh, dkernel, dbias).

    ``g_pre = where(pooled >= 0, g, slope * g)`` in f32; ``dbias`` sums it;
    ``dkernel[t, c, f]`` sums ``bf16(g_pre) * h`` over the selected positions
    shifted by tap t (the cotangent rounded to ``h.dtype``, f32 sums);
    ``dh`` sums ``g_pre * w`` with f32 factors (``w`` the f32 master
    weight) and rounds once to ``h.dtype``. Channels go 8 at a time
    through a dense (B, L, 5, 8) f32 plane, never (B, L, F)."""
    bsz, length, c = h.shape
    k, _, f = w.shape
    rows = length // POOL
    g_pre = torch.where(pooled >= 0, g.float(), negative_slope * g.float())
    dbias = g_pre.sum(dim=(0, 1))
    pos = off.long() + (torch.arange(rows, device=h.device) * POOL)[:, None]
    hf = h.float().reshape(bsz * length, c)
    wf = w.float()
    dh = torch.zeros((bsz * length, c), dtype=torch.float32, device=h.device)
    dkernel = torch.empty((k, c, f), dtype=torch.float32, device=h.device)
    for s in range(0, f, PLAIN_CHUNK):
        fc = min(PLAIN_CHUNK, f - s)
        dyc = torch.zeros((bsz, length + 2 * PAD, fc), dtype=torch.float32,
                          device=h.device)
        dyc.scatter_(1, pos[:, :, s:s + fc] + PAD, g_pre[:, :, s:s + fc])
        # taps[b, q, t, f] = dy[b, q - t + 2, f]: h[q] feeds y at q - t + 2
        taps = torch.stack([dyc[:, 2 * PAD - t: 2 * PAD - t + length]
                            for t in range(k)], dim=2)
        taps = taps.reshape(bsz * length, k * fc)
        dkernel[:, :, s:s + fc] = (taps.to(h.dtype).float().T @ hf).reshape(
            k, fc, c).transpose(1, 2)
        dh += taps @ wf[:, :, s:s + fc].permute(0, 2, 1).reshape(k * fc, c)
    return dh.reshape(bsz, length, c).to(h.dtype), dkernel, dbias


def bwd_exact_inputs(batch: int, length: int, seed: int = 0, f: int = 512):
    """Inputs of kernel B on which every f32 sum is exact and dh is exact in
    bf16, so any order of sums gives the plain version's bits and a term
    missed at a window seam changes them (random inputs hide it under the
    tolerance). Numpy: f32 h (B, L, 64), w (5, 64, F), g and pooled
    (B, L/80, F), int32 offsets (B, L/80, F).

    - h: integers in [-4, 4]; g: integers in {-2, -1, 1, 2}; pooled
      integers >= 0, so ``g_pre = g``;
    - w: one nonzero weight in [-3, 3] per (tap t, output channel f), at
      input channel (f + 13 t) % 64: an element of dh sums at most
      5 F / 64 terms (40 at F=512) of magnitude <= 6, so |dh| <= 240,
      exact in bf16;
    - offsets: half at window positions 0, 1, 78 and 79 (a tap of those
      reaches the neighbouring window), half uniform in 0..79.

    dkernel sums B L / 80 terms of magnitude <= 8 and dbias as many of
    magnitude <= 2, exact in f32 below 2^21 windows."""
    if f % CHANNELS or 5 * f // CHANNELS * 6 > 256:
        raise ValueError(f"bwd_exact_inputs: F={f}: needs F % 64 == 0 and "
                         f"F <= 512 (dh exact in bf16)")
    rng = np.random.default_rng(seed)
    rows = length // POOL
    h = rng.integers(-4, 5, (batch, length, CHANNELS)).astype(np.float32)
    w = np.zeros((KSIZE, CHANNELS, f), np.float32)
    t, n = np.meshgrid(np.arange(KSIZE), np.arange(f), indexing="ij")
    w[t, (n + 13 * t) % CHANNELS, n] = (rng.integers(1, 4, t.shape)
                                        * rng.choice([-1, 1], t.shape))
    g = (rng.integers(1, 3, (batch, rows, f))
         * rng.choice([-1, 1], (batch, rows, f))).astype(np.float32)
    pooled = rng.integers(0, 5, (batch, rows, f)).astype(np.float32)
    seams = np.array([0, 1, POOL - 2, POOL - 1])
    off = np.where(rng.random((batch, rows, f)) < 0.5,
                   seams[rng.integers(0, 4, (batch, rows, f))],
                   rng.integers(0, POOL, (batch, rows, f))).astype(np.int32)
    return h, w, g, pooled, off


def bwd_plan(batch: int, length: int, f: int,
             sms: int) -> Tuple[List[int], List[int]]:
    """Kernel B's split of the B * L / 80 windows (b, r flattened) over its
    CTAs, as window bounds (first 0, last B * L / 80): the dh pass's runs of
    BWD_RUN consecutive windows (the last may be shorter), and the dkernel
    pass's groups, contiguous and as even as the count allows, so that
    ceil(F / BWD_F_TILE) channel tiles x groups give one CTA to each of the
    card's ``sms`` SMs (never more groups than windows)."""
    total = batch * (length // POOL)
    runs = list(range(0, total, BWD_RUN)) + [total]
    tiles = -(-f // BWD_F_TILE)
    groups = max(1, min(total, sms // tiles))
    return runs, [total * i // groups for i in range(groups + 1)]


@functools.lru_cache(maxsize=None)
def bwd_launch_plan(batch: int, length: int, f: int,
                    device: torch.device) -> Tuple[torch.Tensor, int, int]:
    """:func:`bwd_plan` for the card of ``device`` as the kernel takes it:
    one int32 tensor of the run bounds, then the group bounds, on
    ``device``, with the counts of runs and groups; built once per shape."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    runs, groups = bwd_plan(batch, length, f, sms)
    plan = torch.tensor(runs + groups, dtype=torch.int32, device=device)
    return plan, len(runs) - 1, len(groups) - 1


def sgb_dma_weights(w: torch.Tensor, b: torch.Tensor, dtype: torch.dtype):
    """The layout of the contract conv that kernel A and the streamed
    serving kernel take, built once per model (each training step for
    kernel A): w (5, 64, F) -> (F / 64, 5, 64 * 64) in ``dtype``, for each
    group of 64 output channels and each tap the 64 x 64 block [n][c] in
    the 128-byte swizzle (``conv_stack.tap_block_index``, the conv stack's
    tap-block image), so a CTA's 128 channels are one run of 80 KB that
    bulk copies bring into shared memory as ``wgmma`` reads it; b rounded
    to ``dtype`` and held in f32."""
    k, c, f = w.shape
    if k != KSIZE or c != CHANNELS or f % GROUP or b.shape != (f,):
        raise ValueError(f"sgb_dma_weights: w {tuple(w.shape)}, b "
                         f"{tuple(b.shape)}: needs w (5, 64, F) with "
                         f"F % 64 == 0 and b (F,)")
    blocks = w.to(dtype).permute(2, 0, 1).reshape(f // GROUP, GROUP, k, c)
    image = torch.empty((f // GROUP, k, GROUP * c), dtype=dtype,
                        device=w.device)
    image[:, :, tap_block_index(w.device)] = blocks.permute(
        0, 2, 1, 3).reshape(f // GROUP, k, GROUP * c)
    return image, b.to(dtype).float().contiguous()


def dma_weights_plain(image: torch.Tensor) -> torch.Tensor:
    """The (5, 64, F) conv kernel held in an :func:`sgb_dma_weights`
    image: its swizzled blocks read back in order."""
    groups, k, _ = image.shape
    blocks = image[:, :, tap_block_index(image.device)].reshape(
        groups, k, GROUP, CHANNELS)  # [group][t][n][c]
    return blocks.permute(1, 3, 0, 2).reshape(k, CHANNELS, groups * GROUP)


def sgb_contract_pool(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      negative_slope: float = 0.01) -> torch.Tensor:
    """leaky(maxpool80(conv1d_same(h, w) + b)). On a CPU tensor the plain
    version on (w, b), at any C; otherwise :func:`sgb_dma_weights` on
    ``h``'s device, then :func:`sgb_contract_pool_prepared`.

    Args:
        h: (B, L, C) features, L % 80 == 0; bfloat16 with C == 64 on a
            CUDA device.
        w: (5, C, F) conv weights (flax layout), F % 128 == 0 on CUDA.
        b: (F,) bias.
    Returns: (B, L // 80, F) in ``h.dtype``.
    """
    if h.device.type == "cpu":
        _check_plain_inputs("sgb_contract_pool", h, w, b)
        return sgb_contract_pool_reference(h, w, b, negative_slope)
    image, bias = sgb_dma_weights(w.to(h.device), b.to(h.device), h.dtype)
    return sgb_contract_pool_prepared(h, image, bias, negative_slope)


def _check_plain_inputs(what, h, w, b):
    """Shapes of the inputs of a plain version on (w, b), any C and F."""
    _, length, c = h.shape
    f = w.shape[2]
    if w.shape != (KSIZE, c, f) or b.shape != (f,) or length % POOL:
        raise ValueError(f"{what}: h {tuple(h.shape)}, w {tuple(w.shape)}, "
                         f"b {tuple(b.shape)}: needs w (5, C, F), b (F,) "
                         f"and L % 80 == 0")


def check_image_inputs(what: str, h: torch.Tensor, image: torch.Tensor,
                       bias: torch.Tensor) -> None:
    """Shapes of every input of a kernel on the :func:`sgb_dma_weights`
    image (L % 80 == 0, image (F / 64, 5, 64 * C), bias (F,)); for the
    CUDA kernel also types and devices, C == 64 and F % 128 == 0. It reads
    no storage, so a fake tensor (a traced program's) is checked too; the
    launch checks the base address (:func:`check_aligned`)."""
    _, length, c = h.shape
    f = bias.shape[0]
    if (length % POOL or f % GROUP or bias.shape != (f,)
            or image.shape != (f // GROUP, KSIZE, GROUP * c)):
        raise ValueError(f"{what}: h {tuple(h.shape)}, weights "
                         f"{tuple(image.shape)}, bias {tuple(bias.shape)}: "
                         f"needs L % 80 == 0, weights (F / 64, 5, 64 * C) "
                         f"and bias (F,)")
    if h.device.type == "cpu":
        return
    if (h.device.type != "cuda" or h.dtype != torch.bfloat16
            or image.dtype != torch.bfloat16 or bias.dtype != torch.float32
            or not image.device == bias.device == h.device):
        raise TypeError(f"{what}: the CUDA kernel takes bfloat16 on a CUDA "
                        f"device, got {h.dtype} on {h.device} with weights "
                        f"{image.dtype} on {image.device}")
    if c != CHANNELS or f % N_TILE:
        raise ValueError(f"{what}: the CUDA kernel takes C == 64 and "
                         f"F % 128 == 0, got C={c}, F={f}")


def check_aligned(what: str, h: torch.Tensor) -> None:
    """Where ``h`` is contiguous (the wrapper copies it otherwise), a
    16-byte aligned base, which the kernel's tensor map needs."""
    if h.is_contiguous() and h.data_ptr() % 16:
        raise ValueError(f"{what}: the CUDA kernel's tensor map needs h "
                         f"16-byte aligned, got address {h.data_ptr():#x}")


def sgb_contract_pool_prepared(h: torch.Tensor, image: torch.Tensor,
                               bias: torch.Tensor,
                               negative_slope: float = 0.01) -> torch.Tensor:
    """:func:`sgb_contract_pool` on weights in the :func:`sgb_dma_weights`
    image, for every L % 80 == 0: the serving kernel on a CUDA tensor, the
    plain version on a CPU tensor. The launch is
    ``sgb_dma.sgb_contract_pool_dma_prepared``'s, the one launch path of
    the serving instantiation."""
    # sgb_dma imports this module
    from stofnet_tpu_torch.ops.kernels import sgb_dma
    return sgb_dma.sgb_contract_pool_dma_prepared(h, image, bias,
                                                  negative_slope)


def sgb_contract_pool_argmax(h: torch.Tensor, image: torch.Tensor,
                             bias: torch.Tensor, negative_slope: float = 0.01
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel A on weights in the :func:`sgb_dma_weights` image: (pooled
    (B, L/80, F) in ``h.dtype``, int32 offsets (B, L/80, F)), for every
    L % 80 == 0. The CUDA kernel on a CUDA tensor, the plain version on a
    CPU tensor; raises (:func:`check_image_inputs`) on anything else."""
    global argmax_launches
    check_image_inputs("sgb_contract_pool_argmax", h, image, bias)
    if h.device.type == "cpu":
        return sgb_contract_pool_argmax_reference(
            h, dma_weights_plain(image), bias, negative_slope)
    check_aligned("sgb_contract_pool_argmax", h)
    bsz, length, _ = h.shape
    f = bias.shape[0]
    h, image, bias = h.contiguous(), image.contiguous(), bias.contiguous()
    out = torch.empty((bsz, length // POOL, f), dtype=torch.bfloat16,
                      device=h.device)
    off = torch.empty((bsz, length // POOL, f), dtype=torch.int32,
                      device=h.device)
    lib = _build.load("sgb_contract_pool_dma", DMA_SIGNATURE)
    err = lib.sgb_contract_pool_argmax_launch(
        h.data_ptr(), image.data_ptr(), bias.data_ptr(), out.data_ptr(),
        off.data_ptr(), bsz, length, f, float(negative_slope),
        *_build.launch_args(h))
    _build.check(lib, err, "sgb_contract_pool_argmax")
    argmax_launches += 1
    return out, off


def sgb_contract_pool_bwd(h: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                          pooled: torch.Tensor, off: torch.Tensor,
                          negative_slope: float = 0.01
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel B: (dh in ``h.dtype``, dkernel (5, C, F) f32, dbias (F,) f32)
    from the cotangent ``g`` of the pooled output, the pooled output and
    kernel A's offsets; ``w`` (5, C, F) is the f32 master weight. The CUDA
    kernel on a CUDA tensor, :func:`sgb_contract_pool_bwd_reference` on a
    CPU tensor. The kernel sums in a fixed order: two calls on the same
    inputs give the same bits."""
    global bwd_launches
    bsz, length, c = h.shape
    k, _, f = w.shape
    rows = length // POOL
    if (w.shape != (KSIZE, c, f) or length % POOL
            or not g.shape == pooled.shape == off.shape == (bsz, rows, f)):
        raise ValueError(f"sgb_contract_pool_bwd: h {tuple(h.shape)}, w "
                         f"{tuple(w.shape)}, g {tuple(g.shape)}, pooled "
                         f"{tuple(pooled.shape)}, off {tuple(off.shape)}")
    if h.device.type == "cpu":
        return sgb_contract_pool_bwd_reference(h, w, g, pooled, off,
                                               negative_slope)
    if (h.device.type != "cuda" or h.dtype != torch.bfloat16
            or g.dtype != torch.bfloat16 or pooled.dtype != torch.bfloat16
            or off.dtype != torch.int32 or w.dtype != torch.float32
            or not h.device == w.device == g.device == pooled.device
            == off.device):
        raise TypeError("sgb_contract_pool_bwd: the CUDA kernel takes h, g "
                        "and pooled in bfloat16, int32 offsets and an f32 "
                        f"weight on one CUDA device, got h {h.dtype} on "
                        f"{h.device}, g {g.dtype}, pooled {pooled.dtype}, "
                        f"off {off.dtype}, w {w.dtype} on {w.device}")
    if c != CHANNELS or f % BWD_F_MULT or bsz * rows >= 2 ** 31:
        raise ValueError(f"sgb_contract_pool_bwd: the CUDA kernel takes "
                         f"C == 64, F % 64 == 0 and B * L / 80 < 2^31, got "
                         f"C={c}, F={f}, B={bsz}, L={length}")
    h, g, pooled, off = (t.contiguous() for t in (h, g, pooled, off))
    # [f][t][c]: the dh pass streams 32 channels' taps as one 40 KB chunk
    w_ftc = w.permute(2, 0, 1).contiguous()
    plan, n_runs, groups = bwd_launch_plan(bsz, length, f, h.device)
    dh = torch.empty_like(h)
    dkernel = torch.empty((k, c, f), dtype=torch.float32, device=h.device)
    dbias = torch.empty((f,), dtype=torch.float32, device=h.device)
    part_w = torch.empty((groups, k, c, f), dtype=torch.float32,
                         device=h.device)
    part_b = torch.empty((groups, f), dtype=torch.float32, device=h.device)
    lib = _build.load("sgb_contract_pool_bwd", _BWD_SIGNATURE)
    err = lib.sgb_contract_pool_bwd_launch(
        h.data_ptr(), w_ftc.data_ptr(), g.data_ptr(), pooled.data_ptr(),
        off.data_ptr(), dh.data_ptr(), dkernel.data_ptr(), dbias.data_ptr(),
        part_w.data_ptr(), part_b.data_ptr(), plan.data_ptr(), n_runs,
        groups, bsz, length, f, float(negative_slope),
        *_build.launch_args(h))
    _build.check(lib, err, "sgb_contract_pool_bwd")
    bwd_launches += 1
    return dh, dkernel, dbias


class _Trainable(torch.autograd.Function):
    """Custom gradient of the fused contract path (``sgb_kernel.py``'s
    ``custom_vjp``): kernel A forward, kernel B backward, or their plain
    versions when ``plain``."""

    @staticmethod
    def forward(ctx, h, w, b, negative_slope, plain):
        if plain or h.device.type == "cpu":  # no image on the CPU: any C
            _check_plain_inputs("sgb_contract_pool_trainable", h, w, b)
            pooled, off = sgb_contract_pool_argmax_reference(
                h, w, b, negative_slope)
        else:
            image, bias = sgb_dma_weights(w, b, h.dtype)
            pooled, off = sgb_contract_pool_argmax(h, image, bias,
                                                   negative_slope)
        ctx.save_for_backward(h, w, pooled, off)
        ctx.slope, ctx.plain, ctx.bias_dtype = negative_slope, plain, b.dtype
        ctx.mark_non_differentiable(off)
        return pooled, off

    @staticmethod
    def backward(ctx, g, _g_off):
        h, w, pooled, off = ctx.saved_tensors
        bwd = (sgb_contract_pool_bwd_reference if ctx.plain
               else sgb_contract_pool_bwd)
        dh, dkernel, dbias = bwd(h, w, g.to(pooled.dtype), pooled, off,
                                 ctx.slope)
        return (dh, dkernel.to(w.dtype), dbias.to(ctx.bias_dtype), None,
                None)


def sgb_contract_pool_trainable(h: torch.Tensor, w: torch.Tensor,
                                b: torch.Tensor, negative_slope: float = 0.01,
                                plain: bool = False) -> torch.Tensor:
    """Differentiable :func:`sgb_contract_pool`: h (B, L, C), w (5, C, F)
    and b (F,), the weights in their master type (f32); returns
    (B, L/80, F) in ``h.dtype``. Gradients: dh in ``h.dtype``, dw and db in
    the weights' types. ``plain=True`` runs kernel A's and B's plain
    versions on any device (the card's plain path); otherwise a CUDA
    tensor launches the kernels (C == 64, F % 128 == 0, or it raises) and
    a CPU tensor runs the plain versions on (w, b) at any C and F."""
    return _Trainable.apply(h, w, b, negative_slope, plain)[0]
