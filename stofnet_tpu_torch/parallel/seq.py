"""Sequence parallelism for StofNet: the sp axis of a mesh shards the RF
sample axis, and each shard computes the heatmap of its own positions.

This module has no JAX file of its own: JAX shards the sample axis with
``batch_seq_sharding`` and GSPMD inserts a halo exchange for every conv
and the gathers of the SemiGlobalBlock's pooled pathway. Here the forward
needs no exchange inside it. StofNet's reach is finite and follows from
its architecture (:func:`reach`), so each shard runs the unchanged
single-device forward on a widened window of the input (:func:`window`)
and keeps its own positions. The window obeys three rules, which make
every kept position the single device's:

- its start lies on the global pooling grid (a multiple of
  ``semi_global_scale`` from position 0), so its pool windows are the
  global ones;
- its length is congruent to L modulo the scale, so its own centring of
  the upsampled pathway (``pad // 2``) is the global one, and an odd pad
  raises as it does for the whole row;
- at a global end it stops at the end, so the forward's own zero padding
  is the global one; inside the row it reaches at least the reach past
  the shard, so every value the forward pads wrongly at the window's edge
  lies in what is cropped.

At L % 80 == 0 every window keeps L % 80 == 0, so the fused route and its
two kernels serve every shard unchanged.

The halo is the raw input (one channel) that a shard's window needs from
its neighbours: over a live process group it is exchanged point to point
within the sp group (:func:`widen`; as many neighbours as the window
spans, not an all-gather of the row), in one process it is a slice of the
row already on the host (:func:`split_windows`). The frame takes no
gradient, and a shard's loss reads only its own positions, so training
needs no exchange in the backward.
"""

from __future__ import annotations

from typing import Any, Callable, List, Mapping, Sequence, Tuple

import torch
import torch.distributed as dist

from stofnet_tpu_torch.models.stofnet import StofNet
from stofnet_tpu_torch.ops.conv import same

# conv1's and conv_last's paddings are hard-coded (4 and 1), so only these
# kernel sizes keep the length; the SemiGlobalBlock's convs are k5 "SAME"
CONV1_PAD, LAST_PAD, SGB_KERNEL = 4, 1, 5


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


def arch_reach(arch: Mapping[str, Any]) -> int:
    """:func:`reach` of a StofNet architecture given as keywords (a
    pipeline's ``arch``, a module's :func:`module_arch`)."""
    return reach(int(arch.get("num_blocks", 13)),
                 int(arch.get("semi_global_scale", 80)),
                 tuple(arch.get("kernel_sizes", (9, 7, 3))))


def module_arch(model: torch.nn.Module) -> dict:
    """The architecture of a ``models.stofnet.StofNet`` module, for
    :func:`seq_forward`; raises for any other module (the zoo's length
    sharding comes with ROADMAP A.6c)."""
    if not isinstance(model, StofNet):
        raise ValueError(f"sequence parallelism shards StofNet only, not "
                         f"{type(model).__name__}: the zoo under mesh_sp > 1 "
                         f"comes with ROADMAP A.6c")
    return dict(upsample_factor=int(model.upsample_factor),
                num_blocks=int(model.num_blocks),
                semi_global_scale=int(model.semi_global_scale),
                kernel_sizes=(model.conv1.kernel_size[0],
                              model.conv2.kernel_size[0],
                              model.conv_last.kernel_size[0]))


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
            ) -> List[Tuple[Tuple[int, int], Tuple[int, int]]]:
    """For each shard of ``sp``: (its window, its positions within the
    window), both [start, stop) in input samples."""
    halo = arch_reach(arch)
    scale = int(arch.get("semi_global_scale", 80))
    out = []
    for k in range(sp):
        a, b = window(length, sp, k, halo, scale)
        s0, s1 = shard_bounds(length, sp, k)
        out.append(((a, b), (s0 - a, s1 - a)))
    return out


def redundant_share(length: int, sp: int, arch: Mapping[str, Any]) -> float:
    """The share of input positions computed more than once: the windows'
    summed length over the row's, less one."""
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
          ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """This rank's window of the rows whose shard ``x`` (B, C, L / sp) it
    holds, and its positions within it: the halo comes from the ranks of
    its sp group that hold it (``mesh.sp_group``), point to point, each
    rank sending its neighbours the part of its shard their windows need.
    Gloo exchanges host copies, by rule; NCCL copies on the rank's card.
    Without gradient."""
    sp, me = mesh.sp, mesh.sp_index
    n = x.shape[-1]
    length = n * sp
    spans = windows(length, sp, arch)
    where = (torch.device("cpu") if mesh.backend == "gloo"
             else mesh.device)
    mine = x.detach().to(where).contiguous()
    first = mesh.dp_index * sp  # the global rank of sp index 0 in my row
    ops, pieces = [], {}
    for j in range(sp):
        if j == me:
            continue
        (a, b), _ = spans[j]  # j's window: what of my shard it needs
        lo, hi = max(a, me * n), min(b, (me + 1) * n)
        if lo < hi:
            ops.append(dist.P2POp(dist.isend, mine[..., lo - me * n:
                                                   hi - me * n].contiguous(),
                                  first + j, mesh.sp_group))
        (a, b), _ = spans[me]  # my window: what of j's shard I need
        lo, hi = max(a, j * n), min(b, (j + 1) * n)
        if lo < hi:
            pieces[j] = torch.empty((*mine.shape[:-1], hi - lo),
                                    dtype=mine.dtype, device=where)
            ops.append(dist.P2POp(dist.irecv, pieces[j], first + j,
                                  mesh.sp_group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    pieces[me] = mine
    (a, b), within = spans[me]
    parts = []
    for j in range(sp):
        lo, hi = max(a, j * n), min(b, (j + 1) * n)
        if lo < hi:
            parts.append(pieces[j] if j != me
                         else mine[..., lo - me * n:hi - me * n])
    return torch.cat(parts, dim=-1).to(x.device), within


def seq_forward(forward: Callable[[torch.Tensor], torch.Tensor],
                x: torch.Tensor, mesh, arch: Mapping[str, Any]
                ) -> torch.Tensor:
    """``forward`` (any (B, 1, Lw) -> (B, 1, Lw * r) StofNet forward of
    ``arch``) of this rank's shard ``x`` (B, 1, L / sp): the window
    exchanged by :func:`widen`, the forward on it, the heatmap cropped to
    the shard's r * L / sp positions. ``forward(x)`` itself without a mesh
    or at sp = 1."""
    if mesh is None or mesh.sp == 1:
        return forward(x)
    xw, within = widen(mesh, x, arch)
    return crop(forward(xw), within, int(arch.get("upsample_factor", 4)))

