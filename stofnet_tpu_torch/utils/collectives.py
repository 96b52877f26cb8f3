"""Collectives over a mesh's process groups (``parallel/mesh.py``, which
re-exports them).

Each function takes a mesh (``parallel/mesh.Mesh``: its ``group``,
``size``, ``device`` and ``backend``; :func:`gather_seq` its
``sp_group``) and runs on ``torch.distributed``: over the whole mesh, or
over one dp column where the caller passes ``mesh.over_dp()``. They
live here, apart from the mesh, so that the layers that need the global
batch (``models/batchnorm.py``, ``train/steps.py``) import them at the top
without importing ``parallel/``, which imports those layers. Gloo's
collectives run on host copies of CUDA tensors, by rule; NCCL's on copies
on the rank's card.
"""

from __future__ import annotations

from typing import Callable, Iterable, Tuple

import numpy as np
import torch
import torch.distributed as dist


def block(length: int, sp: int, index: int) -> Tuple[int, int]:
    """The positions [lo, hi) of block ``index`` of ``sp`` contiguous
    blocks of a ``length``-position axis (a length shard's, at L % sp ==
    0 its L / sp samples)."""
    return length * index // sp, length * (index + 1) // sp


def accum_rows(batch: int, dp: int, rank: int, accum: int = 1
               ) -> np.ndarray:
    """The rows of a global batch of ``batch`` that dp rank ``rank`` holds,
    in order. At ``accum`` 1 its contiguous block, ``batch / dp`` rows.
    Under ``accum`` N the step splits each rank's rows into N equal
    chunks, and chunk i must be the rank's part of JAX's micro-batch i,
    global rows ``[i B / N, (i + 1) B / N)`` (``jnp.reshape`` of the global
    batch): so the rank holds block ``rank`` of ``dp`` of each
    micro-batch, the micro-batches in order. BatchNorm's statistics and
    the dropout masks of a micro-batch are then those of JAX's."""
    if batch % (dp * accum):
        what = "mesh_dp" if accum == 1 else f"mesh_dp * accum = {dp}*{accum}"
        raise ValueError(f"batch_size={batch} not divisible by {what}")
    micro, b = batch // accum, batch // (accum * dp)
    return np.concatenate([np.arange(i * micro + rank * b,
                                     i * micro + (rank + 1) * b)
                           for i in range(accum)])


def _on_wire(mesh, t: torch.Tensor, op: Callable) -> torch.Tensor:
    """``op(x)`` on ``t`` in place where the backend takes ``t``; gloo on
    a host copy, NCCL on a copy on this rank's card, copied back."""
    where = (torch.device("cpu") if mesh.backend == "gloo"
             else mesh.device)
    if t.device == where and t.is_contiguous():
        op(t)
        return t
    wire = t.to(where).contiguous()
    op(wire)
    with torch.no_grad():
        t.copy_(wire)
    return t


def all_reduce(mesh, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``t`` reduced over the ranks (``sum`` or ``max``), in place; no
    gradient."""
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    return _on_wire(mesh, t, lambda x: dist.all_reduce(x, red,
                                                       group=mesh.group))


class AllReduceSum(torch.autograd.Function):
    """The sum over the ranks, differentiable: each rank's input reaches
    every rank's output, so the gradient is the sum of the ranks'
    cotangents."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_reduce(mesh, x.detach().clone(
            memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return all_reduce(ctx.mesh, g.clone(
            memory_format=torch.contiguous_format)), None


def all_reduce_sum(mesh, x: torch.Tensor) -> torch.Tensor:
    """:class:`AllReduceSum` of ``x``."""
    return AllReduceSum.apply(x, mesh)


def global_mean(mesh, x: torch.Tensor) -> torch.Tensor:
    """The mean of a per-rank mean over equal shards (of rows, or of rows
    and samples): the global batch's, without gradient."""
    return all_reduce(mesh, x.detach().clone()) / mesh.size


def _gather(mesh, t: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    where = (torch.device("cpu") if mesh.backend == "gloo"
             else mesh.device)
    wire = t.detach().to(where).contiguous()
    parts = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(parts, wire, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def gather_rows(mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along axis 0 in rank
    order, on every rank, on ``t``'s device: over ``mesh.over_dp()``, the
    global batch's rows."""
    return _gather(mesh, t, mesh.group, mesh.size, 0)


def gather_seq(mesh, t: torch.Tensor) -> torch.Tensor:
    """The sp group's shards of ``t`` (equal shapes) joined along the last
    axis in sp order: whole rows, on every rank of the group, on ``t``'s
    device. ``t`` itself at sp = 1."""
    if mesh.sp == 1:
        return t
    return _gather(mesh, t, mesh.sp_group, mesh.sp, -1)


def broadcast(mesh, tensors: Iterable[torch.Tensor]) -> None:
    """Each tensor takes rank 0's values, in place."""
    for t in tensors:
        _on_wire(mesh, t.data, lambda x: dist.broadcast(
            x, 0, group=mesh.group))


def broadcast_object(mesh, obj):
    """Rank 0's ``obj`` on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, 0, group=mesh.group)
    return box[0]


def average_gradients(mesh, params: Iterable[torch.Tensor]) -> None:
    """Each parameter's gradient becomes the mean over the ranks: the
    global batch's gradient, where each rank's is its equal shard's mean
    (of rows, or of rows and samples).
    One all-reduce a dtype, over the gradients flattened."""
    by_dtype: dict = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = all_reduce(mesh, torch.cat([g.reshape(-1) for g in grads]))
        flat /= mesh.size
        with torch.no_grad():
            for g, v in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(v.view_as(g))
