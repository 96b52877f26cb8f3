"""Sequence parallelism: the sp axis of a mesh shards the RF sample axis,
and each shard computes its own positions, by a rule of each family of
the registry (:func:`model_arch`).

This module has no JAX file of its own: JAX shards the sample axis with
``batch_seq_sharding`` and GSPMD inserts a halo exchange for every conv,
the gathers of StofNet's pooled pathway and the reductions over a row.
Here a family runs in one of three forms:

- **windows** (StofNet, ESPCN, EDSR, SincNet, Wave-U-Net, GradPeak): the
  family's reach is finite and local, so each shard runs the unchanged
  single-device forward on a widened window of the input (:func:`window`)
  and keeps its own positions. The window obeys three rules, which make
  every kept position the single device's:

  - its start lies on the family's grid (a multiple of StofNet's
    ``semi_global_scale`` or of the unet's ``2 ** n_layers`` from
    position 0), so its pool windows and decimations are the global ones;
  - its length is congruent to L modulo the grid, so StofNet's own
    centring of the upsampled pathway (``pad // 2``) is the global one,
    and an odd pad raises as it does for the whole row;
  - at a global end it stops at the end, so the forward's own zero
    padding is the global one; inside the row it reaches at least the
    reach past the shard, so every value the forward pads wrongly at the
    window's edge lies in what is cropped.

  The unet's x2 resample is align-corners, not shift-invariant, so its
  window resamples on the row's grid (``ops/resample.linear_resample
  (window=)``); at PALA's ten layers its reach spans the row, whose
  window is then the row. GradPeak's Hilbert envelope is an FFT of the row,
  so its window is the row and each shard holds the row's echoes.
  BatchNorm's training statistics
  count each shard's own positions at the layer's resolution
  (``models/batchnorm.positions``, :meth:`Shard.own_slice`), summed over
  every rank;
- **pooled windows** (Zonzini): VALID convs and pools on a ``4 **
  stages`` grid; the windows partition the last stage's positions, whose
  sum over the sp group divided by the row's count is the global mean,
  and the dense head runs on it on every shard;
- **layers** (Kuleshov): its skips concatenate along time, so no window
  is the row's; every tensor's time axis lies in sp blocks and each layer
  fetches the halo its block reads from the blocks that hold it
  (:meth:`MeshExchange.fetch`, differentiable); the dense head's
  contraction over the flattened axis is summed over the sp group.

The input halo of a windowed family is exchanged point to point within
the sp group (:func:`widen`; as many neighbours as the window spans, not
an all-gather of the row), in one process it is a slice of the row
already on the host (:func:`split_windows`, :func:`local_forward`). The
joins go through an exchange: :class:`MeshExchange` across the ranks of a
live mesh (inside autograd), :class:`ThreadExchange` between one
process's shards, each on a thread of its own (the daemon's replicas of
Zonzini and Kuleshov).
:class:`SeqPlan` runs a module's forward as this rank's shard for the
train and eval steps.

At L % 80 == 0 every StofNet window keeps L % 80 == 0, so the fused route
and its two kernels serve every shard unchanged.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import (
    Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple,
)

import torch
import torch.distributed as dist

from stofnet_tpu_torch.models import (
    batchnorm, edsr1d, espcn1d, gradpeak, kuleshov, sincnet, wave_unet,
    zonzini,
)
from stofnet_tpu_torch.models.stofnet import StofNet
from stofnet_tpu_torch.ops.conv import same
from stofnet_tpu_torch.utils.collectives import (
    all_reduce_sum, block, gather_seq,
)

# conv1's and conv_last's paddings are hard-coded (4 and 1), so only these
# kernel sizes keep the length; the SemiGlobalBlock's convs are k5 "SAME"
CONV1_PAD, LAST_PAD, SGB_KERNEL = 4, 1, 5
ROW = "row"  # a reach that spans the row: the window is the whole row
# the families whose output is a heatmap, joined along the row
HEATMAP = ("stofnet", "espcn", "edsr", "sincnet", "unet", "kuleshov")
# the families whose forward joins over the sp group (pooled windows, layers)
JOINED = ("zonzini", "kuleshov")


def reach(num_blocks: int = 13, semi_global_scale: int = 80,
          kernel_sizes: Sequence[int] = (9, 7, 3)) -> int:
    """The largest distance, in input samples, between a position of
    StofNet's output and an input sample it reads, on either side.

    Through the layers, from the output down: conv_last (k3, pad 1),
    conv{num_blocks - 1}..conv2 (k7 "SAME" each), the SemiGlobalBlock
    (where ``semi_global_scale`` S > 1), conv1 (k9, pad 4). A position p
    of the block's output adds the pooled value of the window j with
    ``S j + c <= p < S j + S + c`` (c, the centring ``pad // 2``, is at
    most ``(S - 1) // 2``); the expand conv reads windows j - 2..j + 2, and
    each window the contract conv's outputs ``S i .. S i + S - 1``, each
    of which reads 2 samples further. So the block reaches
    ``c + S - 1 + 2 S + 2`` to the left and ``2 S + S - 1 + 2`` to the
    right. At the default architecture that is 318 samples to the left
    and 279 to the right; the larger is returned.
    """
    k1, k_mid, k_last = (int(k) for k in kernel_sizes)
    if k1 != 2 * CONV1_PAD + 1 or k_last != 2 * LAST_PAD + 1:
        raise ValueError(f"kernel_sizes {tuple(kernel_sizes)}: conv1's pad "
                         f"{CONV1_PAD} and conv_last's {LAST_PAD} keep the "
                         f"length only at k{2 * CONV1_PAD + 1} and "
                         f"k{2 * LAST_PAD + 1}, which a length shard needs")

    def taps(k: int, pad: Tuple[int, int]) -> Tuple[int, int]:
        return pad[0], k - 1 - pad[0]  # (left, right) reach of one conv

    layers = [taps(k_last, (LAST_PAD, LAST_PAD))]
    layers += [taps(k_mid, same(k_mid))] * (int(num_blocks) - 2)
    layers += [taps(k1, (CONV1_PAD, CONV1_PAD))]
    left = sum(t[0] for t in layers)
    right = sum(t[1] for t in layers)
    s = int(semi_global_scale)
    if s != 1:
        c_l, c_r = taps(SGB_KERNEL, same(SGB_KERNEL))  # contract conv
        e_l, e_r = taps(SGB_KERNEL, same(SGB_KERNEL))  # expand conv
        left += (s - 1) // 2 + s - 1 + s * e_l + c_l
        right += s * e_r + s - 1 + c_r
    return max(left, right)


def arch_reach(arch: Mapping[str, Any], length: int = 0) -> int:
    """The reach of a windowed family's rule (:func:`model_arch`), in
    input samples: StofNet's :func:`reach` of its architecture keys (a
    pipeline's ``arch``), another family's ``reach``, the row's
    ``length`` where the reach spans the row."""
    if "reach" in arch:
        return int(length) if arch["reach"] == ROW else int(arch["reach"])
    return reach(int(arch.get("num_blocks", 13)),
                 int(arch.get("semi_global_scale", 80)),
                 tuple(arch.get("kernel_sizes", (9, 7, 3))))


def model_arch(model: torch.nn.Module) -> dict:
    """The sharding rule of a registry module, for :class:`SeqPlan` and
    :func:`windows`: its ``family``, the ``upsample_factor`` of its
    output, and

    - a windowed family (StofNet, ESPCN, EDSR, SincNet, Wave-U-Net,
      GradPeak): its ``reach`` and the ``grid`` its windows start on
      (StofNet's from its architecture keys, :func:`arch_reach`);
    - Zonzini: its ``stages`` (windows on the last stage's positions);
    - Kuleshov: its ``input_length`` (sharded layer by layer)."""
    if isinstance(model, StofNet):
        return dict(family="stofnet",
                    upsample_factor=int(model.upsample_factor),
                    num_blocks=int(model.num_blocks),
                    semi_global_scale=int(model.semi_global_scale),
                    kernel_sizes=(model.conv1.kernel_size[0],
                                  model.conv2.kernel_size[0],
                                  model.conv_last.kernel_size[0]))
    if isinstance(model, espcn1d.ESPCN1D):
        return dict(family="espcn", grid=1, reach=espcn1d.reach(model),
                    upsample_factor=int(model.upscale_factor))
    if isinstance(model, edsr1d.EDSR1D):
        return dict(family="edsr", grid=1, reach=edsr1d.reach(model),
                    upsample_factor=int(model.upscale_factor))
    if isinstance(model, sincnet.SincNet):
        return dict(family="sincnet", grid=1, reach=sincnet.reach(model),
                    upsample_factor=1)
    if isinstance(model, wave_unet.WaveUnet):
        return dict(family="unet", grid=1 << int(model.n_layers),
                    reach=wave_unet.reach(model), upsample_factor=1)
    if isinstance(model, gradpeak.GradPeak):
        return dict(family="gradpeak", grid=1, reach=ROW,
                    upsample_factor=1)
    if isinstance(model, zonzini._ZonziniNet):
        return dict(family="zonzini", stages=len(model.conv_layers),
                    upsample_factor=1)
    if isinstance(model, kuleshov.Kuleshov):
        return dict(family="kuleshov",
                    input_length=int(model.input_length),
                    upsample_factor=int(model.output_fc.out_features
                                        // model.input_length))
    raise ValueError(f"no sequence-parallel rule for "
                     f"{type(model).__name__}")


def family_of(arch: Mapping[str, Any]) -> str:
    """A rule's family: StofNet's where it names none (the architecture
    keys of ``serve.make_pipeline``'s ``pipe.arch``)."""
    return arch.get("family", "stofnet")


def shard_bounds(length: int, sp: int, index: int) -> Tuple[int, int]:
    """The input positions [start, stop) of shard ``index`` of ``sp``;
    refuses a length that sp does not divide, as JAX's driver does."""
    if length % sp:
        raise ValueError(f"sample length {length} not divisible by "
                         f"mesh_sp={sp}")
    n = length // sp
    return index * n, (index + 1) * n


def window(length: int, sp: int, index: int, halo: int,
           scale: int = 80) -> Tuple[int, int]:
    """The input window [start, stop) of shard ``index`` of ``sp`` over a
    row of ``length`` samples, by the module docstring's rules for a
    reach of ``halo`` samples and a pooling ``scale`` (1: no pooling)."""
    s0, s1 = shard_bounds(length, sp, index)
    s = max(1, int(scale))
    start = max(0, s0 - halo) // s * s
    need = s1 + halo
    if need >= length:
        return start, length
    rem = length % s
    # the least stop >= need whose window length is = length (mod s)
    stop = start + rem + -(-(need - start - rem) // s) * s
    return start, min(stop, length)


def windows(length: int, sp: int, arch: Mapping[str, Any]
            ) -> List[Tuple[Tuple[int, int], Tuple[int, ...]]]:
    """For each shard of ``sp``: its input window [start, stop) and its
    own part of the window's output: a windowed family's own positions
    within the window [lo, hi) in input samples, Zonzini's own positions
    of the last stage within the window's and their count in the row
    (``models/zonzini.shard_windows``)."""
    family = family_of(arch)
    if family == "zonzini":
        from stofnet_tpu_torch.models.zonzini import shard_windows
        shard_bounds(length, sp, 0)  # JAX's refusal of L % sp
        return shard_windows(length, sp, int(arch["stages"]))
    if family == "kuleshov":
        raise ValueError("Kuleshov shards layer by layer, not by windows")
    halo = arch_reach(arch, length)
    scale = int(arch.get("grid", arch.get("semi_global_scale", 80)))
    out = []
    for k in range(sp):
        a, b = window(length, sp, k, halo, scale)
        s0, s1 = shard_bounds(length, sp, k)
        out.append(((a, b), (s0 - a, s1 - a)))
    return out


def redundant_share(length: int, sp: int, arch: Mapping[str, Any]) -> float:
    """The share of input positions computed more than once: the windows'
    summed length over the row's, less one. Kuleshov computes each
    position of each layer once (it fetches its halos' values): 0."""
    if family_of(arch) == "kuleshov":
        return 0.0
    return sum(b - a for (a, b), _ in windows(length, sp, arch)) / length - 1


def crop(heat: torch.Tensor, within: Tuple[int, int],
         upsample_factor: int) -> torch.Tensor:
    """A window's heatmap (..., r * window) cropped to the shard's own
    positions ``within`` (input samples within the window)."""
    r = int(upsample_factor)
    return heat[..., within[0] * r:within[1] * r]


def split_windows(x, sp: int, arch: Mapping[str, Any]):
    """One process's shards of a row batch ``x`` (..., L), a numpy array
    or a tensor: for each shard, its window of ``x`` (a slice, the halo
    included) and its positions within the window."""
    return [(x[..., a:b], within)
            for (a, b), within in windows(x.shape[-1], sp, arch)]


def widen(mesh, x: torch.Tensor, arch: Mapping[str, Any]
          ) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """This rank's window of the rows whose shard ``x`` (B, C, L / sp) it
    holds, and its own part within it (:func:`windows`): the halo comes
    from the ranks of its sp group that hold it (``mesh.sp_group``), point
    to point, each rank sending its neighbours the part of its shard their
    windows need (:meth:`MeshExchange.fetch`). Without gradient."""
    length = x.shape[-1] * mesh.sp
    spans = windows(length, mesh.sp, arch)
    xw = MeshExchange(mesh).fetch(
        [(x.detach().transpose(1, 2), length, lambda j: spans[j][0])],
        grad=False)
    return xw.transpose(1, 2), spans[mesh.sp_index][1]


@dataclass(frozen=True)
class Shard:
    """One length shard's forward: shard ``index`` of ``sp`` of rows of
    ``length`` samples (its own samples ``own``), the input ``window`` it
    runs on (None for Kuleshov, which runs on its own samples), its own
    part ``within`` the window's output (:func:`windows`), and the
    ``exchange`` that joins it with the other shards of its rows
    (:class:`MeshExchange` across ranks, :class:`ThreadExchange` in one
    process)."""

    sp: int
    index: int
    length: int
    own: Tuple[int, int]
    window: Optional[Tuple[int, int]]
    within: Optional[Tuple[int, ...]]
    exchange: Any

    def own_slice(self, n: int) -> Tuple[int, int]:
        """The shard's own positions [lo, hi) of a tensor of ``n``
        positions over its window (all of them without one): its window
        covers global positions ``start / f ..`` at ``f = window / n``
        input samples a position, and it owns those whose first sample is
        its own."""
        if self.window is None:
            return 0, n
        a, b = self.window
        f = (b - a) // n
        return (-(-self.own[0] // f) - a // f, -(-self.own[1] // f) - a // f)


def _routes(sp: int, me: int, sources):
    """For :meth:`MeshExchange.fetch`: per peer, the (source, lo, hi) this
    shard sends it and the (source, lo, hi) it receives from it, in
    source order, and the output's pieces in order, as (source, peer, lo,
    hi); positions are global."""
    sends: Dict[int, list] = {}
    recvs: Dict[int, list] = {}
    pieces = []
    for m, (_, length, need) in enumerate(sources):
        lo_me, hi_me = block(length, sp, me)
        a, b = need(me)
        for j in range(sp):
            lo_j, hi_j = block(length, sp, j)
            if j != me:
                ja, jb = need(j)
                lo, hi = max(ja, lo_me), min(jb, hi_me)
                if lo < hi:
                    sends.setdefault(j, []).append((m, lo, hi))
            lo, hi = max(a, lo_j), min(b, hi_j)
            if lo < hi:
                pieces.append((m, j, lo, hi))
                if j != me:
                    recvs.setdefault(j, []).append((m, lo, hi))
    return sends, recvs, pieces


class MeshExchange:
    """The joins of the shards of one dp row across ranks, over the sp
    group of a live mesh: ``sum`` (differentiable, ``AllReduceSum``),
    ``gather`` (whole rows in sp order, without gradient) and ``fetch``
    (point to point, differentiable: the backward sends each fetched
    piece's gradient back to its owner). Gloo exchanges host copies, by
    rule; NCCL copies on the rank's card."""

    def __init__(self, mesh):
        self.mesh, self.row = mesh, mesh.over_sp()
        self.sp, self.index = mesh.sp, mesh.sp_index

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return all_reduce_sum(self.row, t)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        return gather_seq(self.mesh, t)

    def fetch(self, sources, grad: bool = True) -> torch.Tensor:
        """Axis 1 of ``sources``' tensors, each ``(t, length, need)``:
        ``t`` this shard's block (``utils/collectives.block``) of a
        tensor of ``length`` positions on axis 1, ``need(j)`` the global
        range [a, b) shard j reads of it (every shard computes every
        shard's). Returns this shard's ranges, concatenated in source
        order, each from the blocks that hold it."""
        ts = [t for t, _, _ in sources]
        routes = _routes(self.sp, self.index, sources)
        if not grad:
            return _fetch(self, routes, ts, [s[1] for s in sources])
        return _Fetch.apply(self, routes, [s[1] for s in sources], *ts)

    def swap(self, out: Dict[int, torch.Tensor],
             sizes: Dict[int, Tuple[int, ...]], like: torch.Tensor
             ) -> Dict[int, torch.Tensor]:
        """Send ``out[j]`` to sp index j and receive a tensor of
        ``sizes[j]`` from it, for every j, in one batch."""
        mesh = self.mesh
        where = (torch.device("cpu") if mesh.backend == "gloo"
                 else mesh.device)
        first = mesh.dp_index * mesh.sp  # the global rank of sp index 0
        ops, got = [], {}
        for j, t in out.items():
            ops.append(dist.P2POp(dist.isend, t.detach().to(where)
                                  .contiguous(), first + j, mesh.sp_group))
        for j, shape in sizes.items():
            got[j] = torch.empty(shape, dtype=like.dtype, device=where)
            ops.append(dist.P2POp(dist.irecv, got[j], first + j,
                                  mesh.sp_group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return {j: v.to(like.device) for j, v in got.items()}


def _take(t: torch.Tensor, length: int, sp: int, me: int, lo: int,
          hi: int) -> torch.Tensor:
    base = block(length, sp, me)[0]
    return t[:, lo - base:hi - base]


def _fetch(ex, routes, ts, lengths) -> torch.Tensor:
    sends, recvs, pieces = routes
    sp, me = ex.sp, ex.index
    out = {j: torch.cat([_take(ts[m], lengths[m], sp, me, lo, hi)
                         for m, lo, hi in r], 1) for j, r in sends.items()}
    like = ts[0]
    sizes = {j: (like.shape[0], sum(hi - lo for _, lo, hi in r),
                 *like.shape[2:]) for j, r in recvs.items()}
    got = {j: list(v.split([hi - lo for _, lo, hi in recvs[j]], 1))
           for j, v in ex.swap(out, sizes, like).items()}
    parts = [_take(ts[m], lengths[m], sp, me, lo, hi) if j == me
             else got[j].pop(0) for m, j, lo, hi in pieces]
    return torch.cat(parts, 1) if parts else like[:, :0]


class _Fetch(torch.autograd.Function):
    """:meth:`MeshExchange.fetch` inside autograd: each piece's gradient
    goes back to the shard that sent it, and the gradients of the pieces
    this shard sent come back and add into its blocks."""

    @staticmethod
    def forward(ctx, ex, routes, lengths, *ts):
        ctx.ex, ctx.routes, ctx.lengths = ex, routes, lengths
        ctx.shapes = [t.shape for t in ts]
        return _fetch(ex, routes, [t.detach() for t in ts], lengths)

    @staticmethod
    def backward(ctx, g):
        ex, (sends, recvs, pieces), lengths = ctx.ex, ctx.routes, ctx.lengths
        sp, me = ex.sp, ex.index
        grads = [g.new_zeros(s) for s in ctx.shapes]
        back: Dict[int, list] = {}
        at = 0
        for m, j, lo, hi in pieces:
            piece = g[:, at:at + hi - lo]
            at += hi - lo
            if j == me:
                _take(grads[m], lengths[m], sp, me, lo, hi).add_(piece)
            else:
                back.setdefault(j, []).append(piece)
        out = {j: torch.cat(v, 1) for j, v in back.items()}
        sizes = {j: (g.shape[0], sum(hi - lo for _, lo, hi in r),
                     *g.shape[2:]) for j, r in sends.items()}
        for j, v in ex.swap(out, sizes, g).items():
            for (m, lo, hi), piece in zip(sends[j], v.split(
                    [hi - lo for _, lo, hi in sends[j]], 1)):
                _take(grads[m], lengths[m], sp, me, lo, hi).add_(piece)
        return (None, None, None, *grads)


class ThreadExchange:
    """The joins of one process's shards of a batch, each shard's forward
    on a thread of its own (:func:`run_shards`), without gradient: a
    shard posts its tensor on a shared board, all meet at a barrier, each
    reads what it needs (copied to its device), all meet again. Sums add
    in sp order on every shard, so every shard holds the same bits."""

    def __init__(self, sp: int, index: int, board: list,
                 barrier: threading.Barrier):
        self.sp, self.index = sp, index
        self._board, self._barrier = board, barrier

    def _meet(self, value, read: Callable):
        self._board[self.index] = value
        self._barrier.wait()
        try:
            return read(self._board)
        finally:
            self._barrier.wait()

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        def read(board):
            out = board[0].to(t.device)
            for v in board[1:]:
                out = out + v.to(t.device)
            return out
        return self._meet(t, read)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        return self._meet(t, lambda board: torch.cat(
            [v.to(t.device) for v in board], dim=-1))

    def fetch(self, sources, grad: bool = False) -> torch.Tensor:
        def read(board):
            parts = []
            for m, (t, length, need) in enumerate(sources):
                a, b = need(self.index)
                for j in range(self.sp):
                    lo_j, hi_j = block(length, self.sp, j)
                    lo, hi = max(a, lo_j), min(b, hi_j)
                    if lo < hi:
                        parts.append(board[j][m][:, lo - lo_j:hi - lo_j]
                                     .to(t.device))
            return torch.cat(parts, 1)
        return self._meet([t for t, _, _ in sources], read)


_pools: Dict[int, Tuple[ThreadPoolExecutor, threading.Lock]] = {}
_pools_lock = threading.Lock()


def _pool(n: int) -> Tuple[ThreadPoolExecutor, threading.Lock]:
    """n worker threads kept for the process, and the lock that gives
    them to one batch at a time: a thread's first CUDA call sets up its
    state, which a new thread a batch would pay every batch."""
    with _pools_lock:
        if n not in _pools:
            _pools[n] = (ThreadPoolExecutor(n, thread_name_prefix=
                                            f"stofnet-sp{n}"),
                         threading.Lock())
        return _pools[n]


def run_shards(fn: Callable[[int, ThreadExchange], Any], sp: int,
               rows: int = 1) -> List[Any]:
    """``fn(n, exchange)`` for each shard ``n % sp`` of each of ``rows``
    rows ``n // sp``, each on a worker thread of its own (:func:`_pool`),
    all submitted before any is waited on, each row's shards joined
    through one :class:`ThreadExchange` board; the results in ``n``
    order. A shard's failure breaks its row's barrier, so the others
    fail too instead of waiting, and it is raised here."""
    boards = [[None] * sp for _ in range(rows)]
    barriers = [threading.Barrier(sp) for _ in range(rows)]
    out: list = [None] * (sp * rows)
    errors: list = []

    def work(n: int) -> None:
        i, k = divmod(n, sp)
        try:
            out[n] = fn(n, ThreadExchange(sp, k, boards[i], barriers[i]))
        except BaseException as exc:  # noqa: BLE001 (raised below)
            errors.append(exc)
            barriers[i].abort()

    pool, lock = _pool(sp * rows)
    with lock:
        for f in [pool.submit(work, n) for n in range(sp * rows)]:
            f.result()
    if errors:
        first = next((e for e in errors
                      if not isinstance(e, threading.BrokenBarrierError)),
                     errors[0])
        raise first
    return out


def shard_of(arch: Mapping[str, Any], length: int, sp: int, index: int,
             exchange) -> Shard:
    """Shard ``index`` of rows of ``length`` under ``arch``'s rule."""
    own = shard_bounds(length, sp, index)
    if family_of(arch) == "kuleshov":
        return Shard(sp, index, length, own, None, None, exchange)
    (a, b), within = windows(length, sp, arch)[index]
    return Shard(sp, index, length, own, (a, b), within, exchange)


def forward_kwargs(arch: Mapping[str, Any], shard: Shard) -> dict:
    """The keywords that run a family's forward as ``shard``: none where
    the window alone makes it the row's (StofNet, ESPCN, EDSR, SincNet,
    and GradPeak, whose window is the whole row)."""
    if family_of(arch) in ("stofnet", "espcn", "edsr", "sincnet",
                          "gradpeak"):
        return {}
    return {"shard": shard}


def own_output(arch: Mapping[str, Any], pred: torch.Tensor,
               shard: Shard) -> torch.Tensor:
    """A heatmap family's output cropped to the shard's own positions
    (Kuleshov's, whole on every shard, to its block); Zonzini's (B, 1),
    joined already, and GradPeak's echoes, of the whole row, as they are."""
    r = int(arch.get("upsample_factor", 1))
    if family_of(arch) == "kuleshov":
        return pred[..., shard.own[0] * r:shard.own[1] * r]
    if family_of(arch) in HEATMAP:
        return crop(pred, shard.within, r)
    return pred


class SeqPlan:
    """A module's forward on this rank's length shard of a live (dp, sp)
    mesh at sp > 1, by its family's rule (:func:`model_arch`):

    - :meth:`shard` takes the rank's samples (B, 1, L / sp) of its rows
      and returns the forward's input (the window :func:`widen` exchanges;
      Kuleshov's own samples) and its :class:`Shard`; without gradient;
    - :meth:`forward` runs ``forward(x, **kwargs)`` (the module, or a
      caller's wrapper of it) as that shard, BatchNorm's statistics on its
      own positions, and returns :func:`own_output`;
    - :meth:`join` makes an output whole: a heatmap's shards gathered in
      sp order (the decode reads whole rows), Zonzini's and GradPeak's as
      they are."""

    def __init__(self, model: torch.nn.Module, mesh):
        self.arch, self.mesh = model_arch(model), mesh
        self.exchange = MeshExchange(mesh)

    @property
    def heatmap(self) -> bool:
        return self.arch["family"] in HEATMAP

    def shard(self, x: torch.Tensor) -> Tuple[torch.Tensor, Shard]:
        mesh = self.mesh
        length = x.shape[-1] * mesh.sp
        shard = shard_of(self.arch, length, mesh.sp, mesh.sp_index,
                         self.exchange)
        if shard.window is not None:
            x = widen(mesh, x, self.arch)[0]
        return x, shard

    def forward(self, forward: Callable, x: torch.Tensor, shard: Shard,
                **kw) -> torch.Tensor:
        with batchnorm.positions(shard):
            pred = forward(x, **forward_kwargs(self.arch, shard), **kw)
        return own_output(self.arch, pred, shard)

    def join(self, pred: torch.Tensor) -> torch.Tensor:
        return gather_seq(self.mesh, pred) if self.heatmap else pred


def local_forward(forward: Callable, x: torch.Tensor, sp: int,
                  arch: Mapping[str, Any]) -> List[torch.Tensor]:
    """One process's sharded forward of a row batch ``x`` (B, 1, L): each
    shard's :func:`own_output` on its window (Kuleshov: its samples) on a
    thread of its own, joined through a :class:`ThreadExchange`, without
    gradient; the shards' outputs in sp order (a heatmap's concatenate
    into the row's)."""
    length = x.shape[-1]

    def one(k: int, ex: ThreadExchange) -> torch.Tensor:
        shard = shard_of(arch, length, sp, k, ex)
        xs = (x[..., shard.own[0]:shard.own[1]] if shard.window is None
              else x[..., shard.window[0]:shard.window[1]])
        with torch.no_grad(), batchnorm.positions(shard):
            pred = forward(xs, **forward_kwargs(arch, shard))
        return own_output(arch, pred, shard)
    return run_shards(one, sp)
