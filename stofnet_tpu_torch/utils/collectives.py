"""Collectives over a data-parallel mesh's process group (the dp half of
``stofnet_tpu_torch/parallel/mesh.py``, which re-exports them).

Each function takes a mesh (``parallel/mesh.Mesh``: its ``group``,
``dp``, ``device`` and ``backend``) and runs on ``torch.distributed``. They
live here, apart from the mesh, so that the layers that need the global
batch (``models/batchnorm.py``, ``train/steps.py``) import them at the top
without importing ``parallel/``, which imports those layers. Gloo's
collectives run on host copies of CUDA tensors, by rule; NCCL's on copies
on the rank's card.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch
import torch.distributed as dist


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
    """The mean of a per-rank mean over equal shards: the global batch's,
    without gradient."""
    return all_reduce(mesh, x.detach().clone()) / mesh.dp


def gather_rows(mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along axis 0 in rank
    order: the global batch's rows, on every rank, on ``t``'s device."""
    where = (torch.device("cpu") if mesh.backend == "gloo"
             else mesh.device)
    wire = t.detach().to(where).contiguous()
    parts = [torch.empty_like(wire) for _ in range(mesh.dp)]
    dist.all_gather(parts, wire, group=mesh.group)
    return torch.cat(parts).to(t.device)


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
    global batch's gradient, where each rank's is its equal shard's mean.
    One all-reduce a dtype, over the gradients flattened."""
    by_dtype: dict = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = all_reduce(mesh, torch.cat([g.reshape(-1) for g in grads]))
        flat /= mesh.dp
        with torch.no_grad():
            for g, v in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(v.view_as(g))
