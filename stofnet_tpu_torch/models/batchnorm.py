"""BatchNorm with flax's semantics on the channels-last layout (the
``nn.BatchNorm`` of the JAX zoo's Wave-U-Net, Kuleshov and SincNet).

It differs from ``nn.BatchNorm1d`` where a test can see it:

- the running variance is updated with the *biased* batch variance,
  ``E[x^2] - E[x]^2`` clipped at 0 (``nn.BatchNorm1d`` uses the unbiased
  one, an N/(N-1) factor);
- statistics reduce over every axis but the last, in f32 also for a bf16
  input; the normalization runs in f32 and rounds once to the output type
  (the module's ``dtype``, else the promotion of the input's and the
  scale's);
- ``momentum`` is torch's convention (flax's 0.9 is 0.1 here, SincNet's
  0.95 is 0.05); the update is flax's ``m * ra + (1 - m) * stat`` with
  ``m = 1 - momentum``.

With a ``mesh`` (``parallel/mesh.Mesh``, set by the dp train step) the
statistics are the global batch's, as GSPMD computes them: each rank's
``mean`` and ``E[x^2]`` are summed over the ranks inside autograd
(``utils/collectives.AllReduceSum``) and divided by dp (shards are equal), so the gradient
flows through the global statistics; plain DDP's per-rank statistics are
what this avoids.

Under sequence parallelism (inside :func:`positions`, which
``parallel/seq.py`` opens around a shard's forward) a rank's input is a
window of its rows whose halo other shards own: the statistics are then
sums over the shard's *own* positions at this layer's resolution
(``shard.own_slice``), never the halo, with their count, summed over
every rank (dp x sp, inside autograd; over the sp group in one process)
and divided by the global count, so each global position counts once.

The buffers carry the reference's names (``running_mean``,
``running_var``, ``num_batches_tracked``), so a reference ``.pth`` loads
strictly; flax keeps no batch count, so ``num_batches_tracked`` stays as
loaded.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional

import torch
from torch import nn

from stofnet_tpu_torch.utils.collectives import all_reduce_sum

_shard = threading.local()  # the length shard a thread's forward runs


@contextlib.contextmanager
def positions(shard) -> Iterator[None]:
    """BatchNorm's training statistics in this block count ``shard``'s own
    positions (a ``parallel/seq.Shard``; None: every position)."""
    before = getattr(_shard, "value", None)
    _shard.value = shard
    try:
        yield
    finally:
        _shard.value = before


class BatchNorm(nn.Module):
    def __init__(self, features: int, momentum: float = 0.1,
                 eps: float = 1e-5, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.mesh = None
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("running_mean", torch.empty(features))
        self.register_buffer("running_var", torch.empty(features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))
        self.reset_parameters()

    def reset_parameters(self) -> None:
        """flax's init: scale 1, bias 0, mean 0, var 1."""
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)
            self.num_batches_tracked.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (..., C)
        if self.training:
            dims = tuple(range(x.ndim - 1))
            xf = x.float()
            shard = getattr(_shard, "value", None)
            if shard is not None:
                mean, msq = self._own_stats(xf, shard, dims)
            else:
                mean, msq = xf.mean(dims), (xf * xf).mean(dims)
            if self.mesh is not None and shard is None:
                both = all_reduce_sum(self.mesh, torch.stack([mean, msq]))
                mean, msq = both[0] / self.mesh.dp, both[1] / self.mesh.dp
            var = torch.clamp_min(msq - mean * mean, 0.0)
            m = 1.0 - self.momentum
            with torch.no_grad():
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean.detach())
                self.running_var.copy_(m * self.running_var
                                       + (1 - m) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean) * mul + self.bias
        out = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return y.to(out)

    def _own_stats(self, xf: torch.Tensor, shard, dims):
        """(mean, E[x^2]) over every shard's own positions: this shard's
        sums and count, summed over the mesh (or the sp group)."""
        lo, hi = shard.own_slice(xf.shape[-2])
        own = xf[..., lo:hi, :]
        count = own.new_full(own.shape[-1:], own.numel() // own.shape[-1])
        sums = torch.stack([own.sum(dims), (own * own).sum(dims), count])
        sums = (all_reduce_sum(self.mesh, sums) if self.mesh is not None
                else shard.exchange.sum(sums))
        return sums[0] / sums[2], sums[1] / sums[2]
