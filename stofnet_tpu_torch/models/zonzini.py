"""Zonzini's single-echo regression CNNs (replaces
``stofnet_tpu/models/zonzini.py``).

Stages of (conv k10 stride 2 VALID -> ReLU -> max-pool k2 stride 2), a
global average pool over length and a 1024-wide dense head emitting one
ToA per frame, (B, 1). Small (134,481 parameters, chirp) and Large (PALA).
Parameter names are the reference's (``conv_layers.{i}``, ``fc1``,
``fc2``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from stofnet_tpu_torch import DeviceLike, resolve_device
from stofnet_tpu_torch.models.init import materialize
from stofnet_tpu_torch.ops.conv import conv_layer, dense
from stofnet_tpu_torch.utils.stages import Stage, run_stages


class _ZonziniNet(nn.Module):
    CHANNELS: Sequence[int] = ()

    def __init__(self, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        chans = (1, *self.CHANNELS)
        with torch.device("meta"):
            self.conv_layers = nn.ModuleList(
                nn.Conv1d(i, o, 10, stride=2)
                for i, o in zip(chans[:-1], chans[1:]))
            self.fc1 = nn.Linear(chans[-1], 1024)
            self.fc2 = nn.Linear(1024, 1)
        materialize(self, device, generator)

    def forward(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        """(B, 1, L) -> (B, 1): :meth:`stages` run by
        ``utils/stages.run_stages`` on the samples its last stage's
        positions read (the form of :func:`shard_windows`' windows).
        ``shard`` (``parallel/seq.Shard``): ``x`` is the shard's window,
        whose last stage holds the shard's own positions ``shard.within``;
        their sum over the sp group, divided by the row's count of
        positions, is the global mean, and the head runs on it."""
        stages = len(self.conv_layers)
        # the row's refusal of a length too short for the stages
        w = final_length(x.shape[-1] if shard is None else shard.length,
                         stages)
        if shard is None:  # the row but the tail no last-stage position reads
            x = x[..., :(STRIDE * POOL) ** stages * (w - 1) + span(stages)]
        return run_stages(*self.stages(), {"x": x}, shard)

    def stages(self) -> Tuple[List[Stage], List[Dict[str, Any]]]:
        """The forward as two stages, :meth:`features` and :meth:`head`,
        joined by the global average pool (``utils/stages``' ``mean``).

        The pool sums in f64, which holds a sum of bf16 (or, but for the
        last bits, f32) values exactly in any order, and rounds once to the
        features' dtype, as JAX's mean does from its f32 sum: the sharded
        pool then has the single forward's bits."""
        stages = len(self.conv_layers)
        # a window of n last-stage positions: (STRIDE POOL)^stages (n - 1)
        # + span samples, on which every stage's floor division is exact
        grid = (STRIDE * POOL) ** stages
        return ([Stage("features", lambda x: (self.features(x),), ("x",),
                       ("feats",), ("b1t",), ((grid, span(stages) - grid, 1),),
                       ("conv_layers",)),
                 Stage("head", lambda p: (self.head(p),), ("pooled",),
                       ("pred",), ("bc",), (None,), ("fc1", "fc2"))],
                [{"join": "mean", "read": "feats", "write": "pooled"}])

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The conv stages: (B, 1, L) -> (B, W, C)."""
        dt = self.dtype
        h = x.transpose(1, 2)
        if dt is not None:
            h = h.to(dt)
        for i, conv in enumerate(self.conv_layers):
            _check(i, h.shape[1], x.shape[-1], len(self.conv_layers))
            h = F.relu(conv_layer(conv, h, dtype=dt))
            h = F.max_pool1d(h.transpose(1, 2), 2).transpose(1, 2)
        return h

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """The dense head on the global average pool (B, C) -> (B, 1)."""
        dt = self.dtype
        h = F.relu(dense(self.fc1, h, dt))
        return dense(self.fc2, h, dt).to(torch.float32)


def _check(stage: int, width: int, length: int, stages: int) -> None:
    # conv(k10, s2, VALID) emits (L-10)//2+1 and the pool needs 2 of
    # those: below 12 the global pool would average nothing
    if width < 12:
        raise ValueError(
            f"ZonziniNet stage {stage}: length {width} < 12 (input "
            f"L={length} too short for {stages} stride-4 stages; conv+pool "
            f"would emit width 0 and the global pool NaN)")


KERNEL, STRIDE, POOL = 10, 2, 2


def final_length(length: int, stages: int) -> int:
    """The positions of the last stage of a row of ``length``; raises as
    the forward does where a stage is too short."""
    w = int(length)
    for i in range(stages):
        _check(i, w, length, stages)
        w = ((w - KERNEL) // STRIDE + 1) // POOL
    return w


def span(stages: int) -> int:
    """The input samples that one position of the last stage reads, from
    ``4 ** stages`` times its index on: a stage's position reads 12 of the
    stage below (a pool of 2 over convs of 10 taps at stride 2)."""
    out = 1
    for s in range(stages):
        out += (KERNEL + STRIDE * (POOL - 1) - 1) * (STRIDE * POOL) ** s
    return out


def shard_windows(length: int, sp: int, stages: int):
    """For each shard of ``sp``: its input window [a, b) and (lo, hi,
    count): its own positions of the last stage within the window's, and
    the row's count of them. A last-stage position belongs to the shard
    that holds its first input sample (``4 ** stages`` times its index),
    so the shards partition them exactly; a shard that holds none runs
    one position and keeps none. The convs are VALID and the window
    starts on the grid, so each kept position is the row's."""
    w = final_length(length, stages)
    g, n = (STRIDE * POOL) ** stages, length // sp
    out = []
    for k in range(sp):
        q0 = min(w, -(-k * n // g))
        q1 = min(w, -(-(k + 1) * n // g))
        first = q0 if q1 > q0 else w - 1
        a = g * first
        b = min(length, g * (max(q1, first + 1) - 1) + span(stages))
        out.append(((a, b), (q0 - first, q1 - first, w)))
    return out


class ZonziniNetSmall(_ZonziniNet):
    CHANNELS = (16, 32, 64, 64)


class ZonziniNetLarge(_ZonziniNet):
    CHANNELS = (50, 100, 150, 200, 250)


def rewrite_flax_key(key: str) -> str:
    """flax ``conv{i}`` -> torch ``conv_layers.{i}``."""
    head, rest = key.split(".", 1)
    if head.startswith("conv") and head[4:].isdigit():
        return f"conv_layers.{head[4:]}." + rest
    return key
