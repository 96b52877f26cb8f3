"""A forward that joins inside, as data: stages and the joins between
them, and the one runner of both (``parallel/seq.py`` re-exports them;
they live here, as the collectives do, because the model modules that
write their stages are imported by ``parallel/``).

Under sequence parallelism some forwards read the whole row in their
middle: the int8 route's activation scales are row maxima, Zonzini's
global pool is a row mean, Kuleshov's layers read halos and its dense
head contracts the whole flattened row. Such a forward is written as an
ordered list of :class:`Stage` s, each a tensor function, with a join
between each pair: a small JSON-able record (:func:`run_stages` reads
it) that says what the join reads from the shards of a row and what it
writes. So one forward serves

- the whole row (no shard): every join runs on the row alone, where a
  shard's own positions are the whole row and no exchange is made;
- a length shard (a ``parallel/seq.Shard``): each join goes through the
  shard's exchange (``parallel/seq.ThreadExchange`` between one
  process's shards, ``MeshExchange`` across the ranks of a mesh);
- an exported artifact: each stage is a program of its own, polymorphic
  in its inputs' widths, and its manifest carries the joins, which the
  loader runs through the same runner (``serve.PipelineExport``).

The joins, by their ``"join"`` key:

- ``max``: the max of ``read`` (B, n, 1) over the shard's own positions
  (``Shard.own_slice``), joined over the sp group: exact in any order
  (the int8 route's row absmax);
- ``mean``: the f64 sum of ``read`` (B, n, C) over the shard's own
  positions (``Shard.within``: lo, hi and the row's count), joined over
  the sp group, over the count, rounded once to ``read``'s dtype (Zonzini's
  global average pool);
- ``sum``: ``read`` summed over the sp group (Kuleshov's dense head's
  partial products);
- ``fetch``: the input block that a VALID conv (``kernel``, ``stride``)
  reads of the time concatenation of ``sources`` (each ``{"read", "width",
  "held"}``: ``held`` ``"blocks"``, each shard holding its
  ``utils/collectives.block``, or ``"shuffled"``, the x2 pixel shuffle
  of each shard's block of a tensor of ``width / 2``), fetched from the
  shards that hold it; ``place`` names an int64 (2,) host tensor of the
  global positions [lo, hi) of the conv's output block, which a stage
  may read (Kuleshov's dense head slices its weight by it).

A stage's ``layout`` names each read's axes (``b`` the batch, ``t`` the
time axis whose width varies with the shard, any other character a
static axis; ``""`` a host tensor of the join's) and ``widths`` the form
of each ``t`` axis's width, ``(grid, offset, least)``: ``grid * n +
offset`` for n >= least (offset None: the row's length modulo the
grid), so that every floor division of the stage's arithmetic is exact
and an exported stage keeps its widths symbolic without a guard; the
exporter reads both. ``weights`` names the state keys (or key prefixes)
it reads, so that a weightless artifact passes each stage only its own
weights.
"""

from __future__ import annotations

from typing import (
    Any, Callable, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple,
)

import torch

from stofnet_tpu_torch.utils.collectives import block


class Stage(NamedTuple):
    """One stage of a forward that joins inside: ``fn(*reads)`` returns
    the tuple of tensors named ``writes``; ``layout`` and ``weights`` as
    the module docstring says."""
    name: str
    fn: Callable[..., tuple]
    reads: Tuple[str, ...]
    writes: Tuple[str, ...]
    layout: Tuple[str, ...]
    widths: Tuple[Optional[Tuple[int, Optional[int], int]], ...] = ()
    weights: Tuple[str, ...] = ()


def stage_record(stage: Stage) -> Dict[str, Any]:
    """A stage as its artifact's manifest holds it (no function)."""
    return {"name": stage.name, "reads": list(stage.reads),
            "writes": list(stage.writes), "layout": list(stage.layout),
            "weights": list(stage.weights)}


def takes(stage: Stage, key: str) -> bool:
    """Whether state key ``key`` is one of ``stage``'s weights."""
    return any(key == w or key.startswith(w + ".") for w in stage.weights)


def conv_width(width: int, kernel: int, stride: int = 1) -> int:
    """The positions of a VALID conv's output."""
    return (width - kernel) // stride + 1


def run_stages(stages: Sequence[Stage], joins: Sequence[Mapping[str, Any]],
               inputs: Mapping[str, torch.Tensor], shard=None,
               record: Optional[List[tuple]] = None) -> torch.Tensor:
    """Run ``stages`` on ``inputs`` (by name), ``joins[k]`` after stage k
    (:func:`join`), as ``shard`` (None: the whole row); returns the last
    stage's first write. A tensor is dropped once nothing after reads it.
    ``record``: each stage's reads are appended to it (the exporter's
    example inputs)."""
    state = dict(inputs)
    last = {}  # the step reading a name last: 2 k a stage, 2 k + 1 its join
    for k, st in enumerate(stages):
        last.update(dict.fromkeys(st.reads, 2 * k))
        if k < len(joins):
            last.update(dict.fromkeys(_join_reads(joins[k]), 2 * k + 1))
    for k, st in enumerate(stages):
        reads = tuple(state[n] for n in st.reads)
        if record is not None:
            record.append(reads)
        wrote = dict(zip(st.writes, st.fn(*reads)))
        del reads
        _drop(state, last, 2 * k, wrote)
        if k < len(joins):
            _drop(state, last, 2 * k + 1, join(joins[k], state, shard))
    return state[stages[-1].writes[0]]


def _drop(state: dict, last: Mapping[str, int], step: int,
          wrote: Mapping[str, torch.Tensor]) -> None:
    """Drop the tensors that step ``step`` read last, then add what it
    ``wrote``."""
    for name in [n for n in state if last.get(n, -1) == step]:
        del state[name]
    state.update(wrote)


def _join_reads(rec: Mapping[str, Any]) -> List[str]:
    if rec["join"] == "fetch":
        return [s["read"] for s in rec["sources"]]
    return [rec["read"]]


def join(rec: Mapping[str, Any], state: Mapping[str, torch.Tensor],
         shard=None) -> Dict[str, torch.Tensor]:
    """One join (the module docstring) on ``state``: the tensors it
    writes, by name."""
    kind = rec["join"]
    if kind == "fetch":
        return _fetch(rec, state, shard)
    t = state[rec["read"]]
    if kind == "max":
        lo, hi = (0, t.shape[1]) if shard is None else shard.own_slice(
            t.shape[1])
        out = t[:, lo:hi].amax(dim=1, keepdim=True)
        out = out if shard is None else shard.exchange.max(out)
    elif kind == "mean":
        lo, hi, count = ((0, t.shape[1], t.shape[1]) if shard is None
                         else shard.within)
        total = t[:, lo:hi].double().sum(dim=1)
        total = total if shard is None else shard.exchange.sum(total)
        out = (total / count).to(t.dtype)
    elif kind == "sum":
        out = t if shard is None else shard.exchange.sum(t)
    else:
        raise ValueError(f"unknown join {kind!r}")
    return {rec["write"]: out}


def _held(src: Mapping[str, Any], sp: int) -> Callable[[int], tuple]:
    """The global positions [lo, hi) that shard j holds of a source."""
    width = int(src["width"])
    if src.get("held", "blocks") == "shuffled":
        return lambda j: tuple(2 * p for p in block(width // 2, sp, j))
    return lambda j: block(width, sp, j)


def _fetch(rec: Mapping[str, Any], state: Mapping[str, torch.Tensor],
           shard) -> Dict[str, torch.Tensor]:
    """A ``fetch`` join: this shard's input block of the conv (the
    sources' concatenation, whole without a shard) and its place."""
    srcs = rec["sources"]
    widths = [int(s["width"]) for s in srcs]
    k, s = int(rec["kernel"]), int(rec["stride"])
    out_width = conv_width(sum(widths), k, s)
    if shard is None:  # the row, but the tail no output reads
        ts = [state[src["read"]] for src in srcs]
        got = ts[0] if len(ts) == 1 else torch.cat(ts, dim=1)
        got = got[:, :s * (out_width - 1) + k]
        lo, hi = 0, out_width
    else:
        sp = shard.sp
        if out_width < sp:
            raise ValueError(f"a conv of {out_width} positions leaves a "
                             f"shard of mesh_sp={sp} none")
        sources, offset = [], 0
        for src, width in zip(srcs, widths):
            def need(j, o=offset, w=width):
                p0, p1 = block(out_width, sp, j)
                a, b = s * p0, s * (p1 - 1) + k
                return (min(max(a - o, 0), w), min(max(b - o, 0), w))
            sources.append((state[src["read"]], width, need, _held(src, sp)))
            offset += width
        got = shard.exchange.fetch(sources)
        lo, hi = block(out_width, sp, shard.index)
    out = {rec["write"]: got}
    if rec.get("place"):
        out[rec["place"]] = torch.tensor([lo, hi])
    return out
