"""Device meshes, data parallelism and sequence parallelism on
``torch.distributed`` (replaces ``stofnet_tpu/parallel/mesh.py``).

JAX's mesh is one program over the *global* batch: GSPMD partitions it
over a (dp, sp) ``jax.sharding.Mesh`` and inserts the collectives. PyTorch
has no GSPMD, so here each rank of a process group (one process a device)
holds its shard of every batch, and what needs the global batch asks for
it: the loss's normaliser (an all-reduced max), BatchNorm's statistics
(:class:`AllReduceSum` inside autograd), the gradients (a sum over the
ranks, divided by their count) and the evaluation's rows (gathered in
batch order).

- **dp**: the batch axis. :func:`shard_batch` takes this rank's B / dp
  rows of each batch-major tensor.
- **sp**: the sample axis, for every registry model.
  ``shard_batch(seq_axis=)`` takes this rank's L / sp samples of each row;
  ``parallel/seq.py`` runs the family's shard form: a window widened by
  the family's reach with a halo from the neighbours, the single-device
  forward on it and the shard's own positions kept (BatchNorm's
  statistics over own positions), or a join over the sp group (Zonzini's
  pool, Kuleshov's layer halos and dense head, GradPeak's rankings).
  Refused under sp > 1, naming ROADMAP A.6c (:data:`SP_LATER`): the int8
  route, artifacts and encoded inputs.

Ranks are laid out as JAX lays devices out, ``reshape(dp, sp)``: rank r
has dp coordinate ``r // sp`` and sp coordinate ``r % sp``. Under a live
group a mesh also holds its sp group (the ranks of its dp row) and its dp
group (the ranks of its sp column), which every rank makes in the same
order.

Ranks meet through :func:`init_distributed` (``torchrun``, or processes
that a caller starts) or :func:`launch` (this process as rank 0 and the
others spawned, meeting through a ``file://`` store in a temporary
directory); :func:`run_ranks` picks one of the two for an entry point's
``mesh=True``, and :func:`config_mesh` is the mesh of its ``mesh_dp``
and ``mesh_sp`` keys (:func:`mesh_dims`). A rank on the card owns
``cuda:<local rank>``. The backend is NCCL where every rank owns its own
card and gloo elsewhere (the CPU, or ranks sharing a card). Gloo's
collectives run on host copies of CUDA tensors, by rule: PyTorch's table
of backends gives gloo CUDA support for ``all_reduce`` and ``broadcast``
only (PyTorch 2.11 on an H100 took ``all_gather`` of CUDA tensors too).
Every group starts with a timeout, so a rank that waits on a dead one
fails instead of waiting for ever. The collectives themselves are in
``utils/collectives.py`` (re-exported here), which the model and train
layers import.

A mesh built from explicit ``devices`` outside a group holds replicas in
one process: the daemon serves each slice of a batch on its replica, and
under sp each shard of a slice on the replicas of its dp row
(``cli/serve.py``).
"""

from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from stofnet_tpu_torch import DeviceLike, resolve_device
from stofnet_tpu_torch.utils.collectives import (  # noqa: F401 (re-exported)
    AllReduceSum, accum_rows, all_reduce, all_reduce_sum, average_gradients,
    broadcast, broadcast_object, gather_rows, global_mean,
)
from stofnet_tpu_torch.utils.config import Config

SP_LATER = ("mesh_sp > 1 shards the sample axis of every registry model "
            "on chirp, PALA and rat data; the int8 route, artifacts and "
            "encoded inputs under sp come with the next slice of ROADMAP "
            "A.6c")
TIMEOUT = timedelta(seconds=300)

# the device this process joined its group with (init_distributed,
# launch); a group is process-wide state of torch.distributed, and so is
# its rank's device
_joined: dict = {}


def live() -> bool:
    """Whether this process is a rank of a live process group."""
    return dist.is_available() and dist.is_initialized()


def rank_device(device: DeviceLike = None,
                rank: Optional[int] = None) -> torch.device:
    """The device a rank owns: ``cuda`` becomes ``cuda:<local rank>``
    (``LOCAL_RANK`` under ``torchrun``, else ``rank`` or the group's rank,
    modulo the card count); any other device as given."""
    device = resolve_device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        local = rank if rank is not None else (
            dist.get_rank() if live() else 0)
    return torch.device("cuda", int(local) % torch.cuda.device_count())


def default_backend(devices: Sequence[DeviceLike]) -> str:
    """NCCL where every rank owns its own card, gloo elsewhere."""
    devs = [torch.device(d) for d in devices]
    own = len(set(devs)) == len(devs)
    if own and all(d.type == "cuda" for d in devs) and (
            dist.is_nccl_available()):
        return "nccl"
    return "gloo"


def _join(init_method: str, rank: int, world: int, device: torch.device,
          backend: str, timeout: timedelta) -> None:
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, timeout=timeout)
    _joined["device"] = device


def leave() -> None:
    """Leave the process group this process joined."""
    _joined.clear()
    if live():
        dist.destroy_process_group()


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     backend: Optional[str] = None,
                     device: DeviceLike = None,
                     timeout: timedelta = TIMEOUT) -> None:
    """Join a process group of ``num_processes`` ranks as rank
    ``process_id``; nothing for one process. ``coordinator_address`` is
    ``host:port`` (TCP, rank 0 listens), a ``file://`` or ``tcp://`` URL,
    or None for ``torchrun``'s environment. ``device`` (the card unless
    ``cpu``) becomes :func:`rank_device`; ``backend`` defaults to NCCL on
    the card and gloo on the CPU."""
    if num_processes is None or int(num_processes) <= 1:
        return
    addr = coordinator_address
    init = ("env://" if addr is None else addr if "://" in addr
            else f"tcp://{addr}")
    dev = rank_device(device, process_id)
    _join(init, int(process_id), int(num_processes), dev,
          backend or ("nccl" if dev.type == "cuda" else "gloo"), timeout)


def _world_devices() -> List[torch.device]:
    """Each rank's device, in rank order."""
    mine = _joined.get("device")
    if mine is None:  # a group this module did not start
        mine = (rank_device("cuda") if dist.get_backend() == "nccl"
                else torch.device("cpu"))
    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, str(mine))
    return [torch.device(d) for d in out]


def local_devices(device: DeviceLike = None, dp: Optional[int] = None,
                  sp: int = 1) -> List[torch.device]:
    """The devices a (dp, sp) mesh takes on this host, for
    :func:`make_mesh`: on the card the first dp * sp cards (all of them
    when dp is None; more than there are is left to ``make_mesh`` to
    refuse), on the CPU dp * sp CPU devices (dp 1 by default)."""
    device = resolve_device(device)
    if device.type != "cuda":
        return [device] * ((dp or 1) * sp)
    cards = [torch.device("cuda", i)
             for i in range(torch.cuda.device_count())]
    return cards if dp is None or dp * sp > len(cards) else cards[:dp * sp]


@dataclass(frozen=True)
class Mesh:
    """A (dp, sp) mesh over ``devices`` (rank order, rank r at dp
    coordinate ``r // sp`` and sp coordinate ``r % sp``). Under a live
    process group, ``group`` is it and ``rank`` this process's rank, whose
    device is :attr:`device`; ``sp_group`` holds the ranks of this rank's
    dp row and ``dp_group`` those of its sp column. Without one, the
    devices hold replicas in one process."""

    dp: int
    sp: int
    devices: Tuple[torch.device, ...]
    group: Any = None
    rank: int = 0
    sp_group: Any = None
    dp_group: Any = None

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "sp": self.sp}

    @property
    def size(self) -> int:
        return self.dp * self.sp

    @property
    def dp_index(self) -> int:
        return self.rank // self.sp

    @property
    def sp_index(self) -> int:
        return self.rank % self.sp

    @property
    def device(self) -> torch.device:
        return self.devices[self.rank]

    @property
    def backend(self) -> Optional[str]:
        return None if self.group is None else dist.get_backend(self.group)

    def over_dp(self) -> "Mesh":
        """The mesh of this rank's sp column: dp ranks, one a row, over
        ``dp_group``; its collectives reduce and gather rows. The mesh
        itself at sp = 1."""
        if self.sp == 1:
            return self
        return Mesh(self.dp, 1, self.devices[self.sp_index::self.sp],
                    self.dp_group, self.dp_index, None, self.dp_group)


    def over_sp(self) -> "Mesh":
        """The mesh of this rank's dp row: sp ranks over ``sp_group``,
        whose collectives join the shards of the row's batch."""
        row = self.devices[self.dp_index * self.sp:
                           (self.dp_index + 1) * self.sp]
        return Mesh(1, self.sp, row, self.sp_group, self.sp_index,
                    self.sp_group, None)


def make_mesh(dp: Optional[int] = None, sp: int = 1,
              devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """Build a (dp, sp) mesh. ``dp`` defaults to n_devices // sp.

    ``devices`` None: under a live group, its ranks' devices (the mesh
    binds the group); outside one, the cards, or one CPU device. Given,
    the devices hold replicas in this process (no group). On the CPU a
    caller may list ``cpu`` dp times: any dp runs there."""
    group = None
    if devices is None and live():
        group, devices = dist.group.WORLD, _world_devices()
    elif devices is None:
        devices = local_devices("cuda" if torch.cuda.is_available()
                                else "cpu")
    devices = tuple(torch.device(d) for d in devices)
    n = len(devices)
    if dp is None:
        if n % sp:
            raise ValueError(f"{n} devices not divisible by sp={sp}")
        dp = n // sp
    if dp * sp != n:
        raise ValueError(f"dp*sp = {dp * sp} != {n} devices")
    if group is None:
        return Mesh(int(dp), int(sp), devices)
    rank = dist.get_rank()
    sp_group, dp_group = _groups(int(dp), int(sp), rank)
    return Mesh(int(dp), int(sp), devices, group, rank, sp_group, dp_group)


def _groups(dp: int, sp: int, rank: int) -> Tuple[Any, Any]:
    """This rank's (sp group, dp group) of a (dp, sp) mesh over the live
    group, made once a shape a process: every rank makes every row's and
    every column's group, in the same order (``new_group`` is collective).
    At sp = 1 the dp group is the world and there is no sp group."""
    if sp == 1:
        return None, dist.group.WORLD
    made = _joined.setdefault("groups", {})
    if (dp, sp) not in made:
        rows = [dist.new_group([d * sp + k for k in range(sp)],
                               timeout=TIMEOUT) for d in range(dp)]
        cols = [dist.new_group([d * sp + k for d in range(dp)],
                               timeout=TIMEOUT) for k in range(sp)]
        made[(dp, sp)] = rows, cols
    rows, cols = made[(dp, sp)]
    return rows[rank // sp], cols[rank % sp]


@dataclass(frozen=True)
class Sharding:
    """Where a tensor's axes lie on a mesh: ``spec`` names the mesh axis
    of each tensor axis (None: replicated), as JAX's ``PartitionSpec``."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]

    def take(self, x):
        """This rank's part of ``x`` (a tensor or numpy array): along an
        axis named ``dp`` the block of its dp coordinate, along one named
        ``sp`` the block of its sp coordinate."""
        mesh, index = self.mesh, [slice(None)] * x.ndim
        for axis, name in enumerate(self.spec):
            if name == "dp":
                n, i = x.shape[axis], mesh.dp_index
                if n % mesh.dp:
                    raise ValueError(f"batch {n} not divisible by "
                                     f"mesh_dp={mesh.dp}")
                b = n // mesh.dp
            elif name == "sp":
                n, i = x.shape[axis], mesh.sp_index
                if n % mesh.sp:
                    raise ValueError(f"sample length {n} not divisible by "
                                     f"mesh_sp={mesh.sp}")
                b = n // mesh.sp
            else:
                continue
            index[axis] = slice(i * b, (i + 1) * b)
        return x[tuple(index)]


def batch_sharding(mesh: Mesh, ndim: int) -> Sharding:
    """Shard axis 0 over dp, replicate the rest."""
    return Sharding(mesh, ("dp", *([None] * (ndim - 1))))


def batch_seq_sharding(mesh: Mesh, ndim: int, seq_axis: int = -1
                       ) -> Sharding:
    """Shard axis 0 over dp and the sample axis over sp."""
    seq_axis = seq_axis % ndim
    spec: List[Optional[str]] = [None] * ndim
    spec[0] = "dp"
    spec[seq_axis] = "sp"
    return Sharding(mesh, tuple(spec))


def replicate(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Every rank takes rank 0's parameters and buffers, in place."""
    if mesh.group is not None:
        with torch.no_grad():
            broadcast(mesh, [*module.parameters(), *module.buffers()])
    return module


def shard_batch(mesh: Mesh, tree, seq_axis: Optional[int] = None,
                accum: int = 1):
    """This rank's part of every batch-major leaf of ``tree`` (a tensor, a
    numpy array, or a dict, list or tuple of them): its rows, and with
    ``seq_axis`` also its samples along that axis of every leaf of two or
    more axes (:func:`batch_seq_sharding`), as JAX's; 0-d leaves
    replicate. Frames take ``seq_axis``; GT tensors, sharded over dp
    only, go in a call without it, as JAX's driver puts them. A training
    batch of ``accum`` micro-batches gives each rank the rows of
    ``utils/collectives.accum_rows``: its slice of each micro-batch."""
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v, seq_axis, accum)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(mesh, v, seq_axis, accum)
                          for v in tree)
    if tree.ndim == 0:
        return tree
    if accum > 1 and mesh.dp > 1:  # the rank's rows as its dp block
        n = tree.shape[0]
        order = np.concatenate([accum_rows(n, mesh.dp, r, accum)
                                for r in range(mesh.dp)])
        tree = tree[torch.from_numpy(order) if torch.is_tensor(tree)
                    else order]
    if seq_axis is not None and tree.ndim >= 2:
        return batch_seq_sharding(mesh, tree.ndim, seq_axis).take(tree)
    return batch_sharding(mesh, tree.ndim).take(tree)


def mesh_dims(cfg: Mapping[str, Any]) -> Tuple[Optional[int], int]:
    """(``mesh_dp`` or None, ``mesh_sp``) of an entry point's config."""
    return (int(cfg.get("mesh_dp") or 0) or None,
            int(cfg.get("mesh_sp", 1) or 1))


def refuse_sp(cfg: Mapping[str, Any], what: str) -> None:
    """``SystemExit`` naming ROADMAP A.6c (:data:`SP_LATER`) where a
    config asks ``mesh_sp > 1`` of ``what``, a path sp does not shard."""
    sp = mesh_dims(cfg)[1]
    if cfg.get("mesh") and sp > 1:
        raise SystemExit(f"mesh_sp={sp} with {what} is refused: {SP_LATER}")


def config_mesh(cfg: Mapping[str, Any],
                check: Optional[Callable[[int], None]] = None,
                devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """The mesh of a config's ``mesh_dp``/``mesh_sp``: over the live group
    (``devices`` None) or over ``devices``; ``check(dp)`` raises where the
    caller cannot split its work dp ways (a batch, a member count)."""
    dp, sp = mesh_dims(cfg)
    mesh = make_mesh(dp, sp, devices)
    if check is not None:
        check(mesh.dp)
    return mesh


def _rank_run(run: Callable, items: dict):
    """``run`` on a rank that :func:`run_ranks` started."""
    return run(Config(items))


def run_ranks(run: Callable[[Config], Any], cfg: Config,
              check: Optional[Callable[[int], None]] = None):
    """``run(cfg)`` on the ranks of an entry point's ``mesh=True``, from a
    process outside any group; returns rank 0's result. Under ``torchrun``
    (``WORLD_SIZE`` > 1) this process joins as its rank. Otherwise it is
    rank 0 of the ranks started here, on the devices of
    :func:`local_devices` (``cfg``'s ``device``, ``mesh_dp``,
    ``mesh_sp``), refused as :func:`config_mesh` refuses before any rank
    starts. ``run`` must be importable by name."""
    world = int(os.environ.get("WORLD_SIZE", 1))
    if world > 1:
        init_distributed(None, world, int(os.environ["RANK"]),
                         device=cfg.get("device"))
        try:
            return run(cfg)
        finally:
            leave()
    dp, sp = mesh_dims(cfg)
    mesh = config_mesh(cfg, check, local_devices(cfg.get("device"), dp, sp))
    return launch(_rank_run, (run, dict(cfg)), devices=mesh.devices)


# ---- ranks ---------------------------------------------------------------

def _child(i: int, fn: Callable, args: tuple, init: str, world: int,
           devices: List[str], backend: str, timeout: timedelta,
           threads: int) -> None:
    """Rank ``i + 1`` of :func:`launch`, in a spawned process."""
    torch.set_num_threads(threads)
    rank = i + 1
    _join(init, rank, world, torch.device(devices[rank]), backend, timeout)
    try:
        fn(*args)
    finally:
        leave()


def launch(fn: Callable, args: tuple = (), *,
           devices: Sequence[DeviceLike], backend: Optional[str] = None,
           timeout: timedelta = TIMEOUT):
    """``fn(*args)`` on ``len(devices)`` ranks, rank r on ``devices[r]``:
    this process is rank 0 and returns its result; the others are spawned
    (``torch.multiprocessing``, ``spawn``; ``fn`` must be importable by
    name) and joined. The ranks meet through a ``file://`` store in a
    temporary directory, so launches never contend for a port; CPU threads
    are split between the ranks. A rank that fails fails the launch: the
    others are stopped."""
    devices = [torch.device(d) for d in devices]
    world = len(devices)
    backend = backend or default_backend(devices)
    threads = torch.get_num_threads()
    mine = max(1, threads // world)
    with tempfile.TemporaryDirectory(prefix="stofnet-mesh-") as tmp:
        init = f"file://{tmp}/store"
        ctx = None
        if world > 1:
            ctx = mp.start_processes(
                _child, args=(fn, args, init, world,
                              [str(d) for d in devices], backend, timeout,
                              mine),
                nprocs=world - 1, join=False, start_method="spawn")
        torch.set_num_threads(mine)
        try:
            _join(init, 0, world, devices[0], backend, timeout)
            try:
                out = fn(*args)
            finally:
                leave()
            deadline = time.monotonic() + timeout.total_seconds()
            while ctx is not None and not ctx.join(
                    max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"a rank of {world} did not "
                                       f"finish within {timeout}")
        except BaseException as exc:
            if ctx is not None:
                _stop(ctx, exc)
            raise
        finally:
            torch.set_num_threads(threads)
    return out


def _stop(ctx, exc: BaseException) -> None:
    """Stop the spawned ranks of a failed launch; a rank's own failure, if
    one ended first, is raised from ``exc``."""
    try:
        ctx.join(1.0)
    except mp.ProcessRaisedException as child:
        raise child from exc
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(10.0)
