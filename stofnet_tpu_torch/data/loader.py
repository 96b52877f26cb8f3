"""Batching, splitting and the host-to-device copy (replaces
``stofnet_tpu/data/loader.py``).

``split_dataset``, ``DataLoader`` (a thread pool of ``__getitem__`` calls)
and ``default_num_workers`` are the JAX package's. An item's work holds
the interpreter lock for most of its time, so more threads read little
faster than one. Its
``jax.device_put`` becomes :class:`DevicePut`: each host batch is copied
into pinned staging memory, then to the card with ``non_blocking`` copies
on a side CUDA stream, so that ``pipeline_batches``' copy of batch N+1
runs under the step on batch N.
"""

from __future__ import annotations

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from stofnet_tpu_torch.utils.collectives import accum_rows

_STAGING_SETS = 3  # pinned buffer sets of DevicePut; any count >= 1 is
# correct, since a refill waits on its set's last copy


def default_num_workers() -> int:
    """The reference's worker count heuristic."""
    return min(4, os.cpu_count() or 1)


def split_dataset(n: int, val_percent: float, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Seeded random split; returns (train_indices, val_indices)."""
    n_val = int(n * val_percent)
    perm = np.random.default_rng(seed).permutation(n)
    return perm[n_val:], perm[:n_val]


class DataLoader:
    """Iterates a dataset subset in batches of stacked numpy arrays.

    Items must be tuples; array-like fields are stacked, str fields are
    collected into lists. ``drop_last`` drops a short last batch.

    ``shard=(rank, dp)`` yields rank ``rank``'s rows of each global batch
    of ``batch_size`` (its ``batch_size / dp`` items, in the
    single-process order: same split, same shuffle), and reads only
    those items: a data-parallel rank's loader
    (``parallel/mesh.shard_batch`` of the global batch). With ``accum``
    (a training loader of ``accum`` micro-batches) they are the rows of
    ``utils/collectives.accum_rows``: the rank's dp slice of each
    micro-batch, in micro-batch order.
    """

    def __init__(self, dataset, indices: Optional[Sequence[int]] = None,
                 batch_size: int = 4, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0,
                 num_workers: int = 0, prefetch_batches: int = 2,
                 shard: Tuple[int, int] = (0, 1), accum: int = 1):
        self.dataset = dataset
        self.indices = np.asarray(
            indices if indices is not None else np.arange(len(dataset)))
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._seed = seed
        self.rng = np.random.default_rng(seed)
        self.num_workers = int(num_workers)
        self.prefetch_batches = max(1, int(prefetch_batches))
        self.rank, self.dp = (int(v) for v in shard)
        self._rows = accum_rows(batch_size, self.dp, self.rank,
                                int(accum) if self.dp > 1 else 1)
        if self.dp > 1 and not drop_last:
            raise ValueError("a sharded loader drops the short last batch: "
                             "drop_last=True")

    def set_epoch(self, epoch: int) -> None:
        """Reseed the shuffle stream to (seed, epoch): epoch e's batch order
        is a function of (seed, e) alone, so a run resumed at epoch e
        replays the order an uninterrupted run would have used."""
        self.rng = np.random.default_rng((self._seed, int(epoch)))

    def __len__(self) -> int:
        n = len(self.indices)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batch_indices(self):
        order = self.indices.copy()
        if self.shuffle:
            self.rng.shuffle(order)
        bs = self.batch_size
        stop = len(order) - (len(order) % bs) if self.drop_last else len(order)
        return [order[i:i + bs][self._rows] for i in range(0, stop, bs)]

    def __iter__(self) -> Iterator[Tuple]:
        batches = self._batch_indices()
        if self.num_workers <= 0:
            for b in batches:
                items = [self.dataset[int(j)] for j in b]
                yield tuple(_collate(field) for field in zip(*items))
            return
        # thread-pool items, prefetch_batches ahead, so item loads overlap
        # the device step
        with ThreadPoolExecutor(self.num_workers) as pool:
            pending = deque()
            ahead = self.prefetch_batches
            for b in batches[:ahead]:
                pending.append([pool.submit(self.dataset.__getitem__, int(j))
                                for j in b])
            for k in range(len(batches)):
                if k + ahead < len(batches):
                    pending.append(
                        [pool.submit(self.dataset.__getitem__, int(j))
                         for j in batches[k + ahead]])
                items = [f.result() for f in pending.popleft()]
                yield tuple(_collate(field) for field in zip(*items))


def _collate(field):
    first = field[0]
    if isinstance(first, str):
        return list(field)
    return np.stack([np.asarray(x) for x in field])


class StagedBatch(tuple):
    """Device tensors of one batch and the event of their copy:
    :meth:`ready` makes the current stream wait for the copy before any
    work it queues later reads them."""

    event: Optional[torch.cuda.Event] = None

    def ready(self) -> "StagedBatch":
        if self.event is not None:
            torch.cuda.current_stream(self[0].device).wait_event(self.event)
        return self


class DevicePut:
    """``put(batch) -> StagedBatch`` of tensors on the device, for a batch
    of numpy arrays.

    On the CPU each array becomes a tensor over the same memory. On the
    card each array is copied into a pinned staging buffer (a
    ``non_blocking`` copy from pageable memory would be synchronous), and
    from there with a ``non_blocking`` copy on a side stream, whose event
    the batch carries: the consumer calls ``ready()`` (``pipeline_batches``
    does) before it queues work that reads the batch, so the copy of the
    next batch runs under the step on this one. ``record_stream`` marks
    each device tensor as used by the calling stream, so the caching
    allocator does not hand its memory to a later copy while a step still
    reads it; a staging buffer is refilled only after its last copy's
    event has completed (``_STAGING_SETS`` sets of buffers, used in turn:
    one for the batch a step reads, one for the batch being copied, one
    being filled, so a refill seldom waits)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._slots: List[Optional[Tuple[List[torch.Tensor],
                                         torch.cuda.Event]]] = (
            [None] * _STAGING_SETS)
        self._next = 0
        self._stream = None

    def __call__(self, batch: Sequence[np.ndarray]) -> StagedBatch:
        host = [torch.from_numpy(np.ascontiguousarray(x)) for x in batch]
        if self.device.type != "cuda":
            return StagedBatch(t.to(self.device) for t in host)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        i = self._next
        self._next = (i + 1) % len(self._slots)
        staged = self._slots[i]
        if staged is not None:
            staged[1].synchronize()  # its last copy has left the buffers
        if staged is None or [(b.shape, b.dtype) for b in staged[0]] != [
                (t.shape, t.dtype) for t in host]:
            bufs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    for t in host]
        else:
            bufs = staged[0]
        for b, t in zip(bufs, host):
            b.copy_(t)
        compute = torch.cuda.current_stream(self.device)
        done = torch.cuda.Event()
        with torch.cuda.stream(self._stream):
            out = StagedBatch(b.to(self.device, non_blocking=True)
                              for b in bufs)
            done.record(self._stream)
        for t in out:
            t.record_stream(compute)
        self._slots[i] = (bufs, done)
        out.event = done
        return out


def pipeline_batches(host_iter, put: Callable):
    """One-deep device prefetch yielding (host_batch, device_batch) pairs.

    ``put`` maps a host batch to device tensors (a :class:`DevicePut`);
    the put of batch N+1 is issued before batch N is yielded, so its copy
    rides under the step on batch N, and each device batch is made
    ``ready()`` for the current stream as it is yielded. Host batches stay
    available for logging and plotting.
    """
    it = iter(host_iter)
    try:
        nxt = next(it)
    except StopIteration:
        return
    nxt_dev = put(nxt)
    for host in it:
        cur, cur_dev = nxt, nxt_dev
        nxt, nxt_dev = host, put(host)
        yield cur, _ready(cur_dev)
    yield nxt, _ready(nxt_dev)


def _ready(batch):
    return batch.ready() if isinstance(batch, StagedBatch) else batch
