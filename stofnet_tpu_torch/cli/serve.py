"""Serving daemon: dynamic-batching TCP inference on one command (replaces
``stofnet_tpu/cli/serve.py``). From artifacts of ``cli/export.py`` of any
family, with no model code or checkpoint (several, comma-separated, route
requests by waveform length, one artifact a length)::

    python -m stofnet_tpu_torch.cli.serve artifact=l8000.pt2,l2000.pt2 \
        port=7733 [max_batch=128]

or from a checkpoint::

    python -m stofnet_tpu_torch.cli.serve model_file=different-armadillo \\
        ckpt_dir=ckpts length=8000 port=7733 [th=Null] [max_echoes=64] \\
        [dtype=auto|bfloat16|float32] [input_enc=bf16|s16|s8c<n>] \\
        [int8_calib=x.npy [int8_stack=4,8,10] [int8_eq_alpha=0.5]
         [int8_bias_correct=True]] [device=cpu]

It serves a StofNet checkpoint (a reference ``.pth`` or a checkpoint of
``train/checkpoint.py``, found by prefix in ``ckpt_dir=``) through
``serve.make_pipeline``: the fused route on the card's kernels at every
L % 80 == 0, the int8-SGB route with ``int8_calib=``, the ``StofNet``
module elsewhere. ``dtype=auto`` (the default) serves bf16 where its
decode agrees with f32 on 0.99 of the coords of an echo-bearing batch.
``model=edsr|espcn|zonzini|unet|sincnet|kuleshov|gradpeak`` serves that
family of the registry from its checkpoint through the same switch, with
the exporter's build arguments (its
``resolve_zoo_variables_and_overrides``; gradpeak needs no
``model_file=``); int8 serving targets model=stofnet only.

``mesh=True [mesh_dp=N]`` splits every served batch over dp devices:
the daemon stays one process and holds one pipeline replica a mesh
device (the first mesh_dp cards, all of them by default; on the CPU
mesh_dp replicas, 1 by default), built from the checkpoint or loaded
from the artifact on its device (``serve.load_pipeline`` moves the
programs to each card of the mesh), encoded inputs included (the encode
stays on the host). Each batch goes to the replicas in dp equal slices,
every slice launched before any result is copied back, and their coords
come back concatenated in order: rows are independent, so no collective
is needed, and this is the batch split that JAX's GSPMD makes. As JAX's
``_mesh_adjust``: ``max_batch`` must divide by dp, and only
dp-divisible buckets are served. Departure: a fixed-batch artifact runs
its whole batch on each replica, so under dp > 1 it is refused (export
it with ``batch=b``).

``mesh=True mesh_sp=N`` also splits each row of a slice along L over
the sp replicas of the slice's dp row (dp * sp devices, JAX's
``reshape(dp, sp)``), from a checkpoint of any family or from an
artifact. Each replica runs its forward (``make_pipeline``'s
``heatmap``, or an artifact's forward program, which
``cli/export.py`` writes apart from the decode and polymorphic in the
window's length: for StofNet the fused kernels at L % 80 == 0, the
module elsewhere) on its shard's window, the row with the halo that the
family's reach needs (``parallel/seq.py``; GradPeak's is the row), and
keeps its own positions; the shards' outputs are joined in order on the
slice's first device and decoded there. Every shard is launched before
any result is copied back. With ``input_enc=`` the host encodes each
slice once and each replica copies only its window's codes and the
scales they need, and dequantizes them on its device. The int8 route
(``int8_calib=``, calibrated once at build on the whole batch),
Zonzini and Kuleshov join inside their forward, from a checkpoint or an
artifact (whose forward is their stages, ``serve.PipelineExport``):
their replicas run its shard form (``shard``), one thread each, all dp
rows together, joined in process (``parallel/seq.ThreadExchange``: the
int8 route's activation scales, row maxima; Zonzini's pool and
Kuleshov's halos and dense head summed). JAX's refusals stay:
``length`` must divide by sp, and ``s8c<n>`` by n % sp != 0 (its chunk
scales shard over sp). Refused with ``mesh_sp > 1``, to be exported
again: an artifact of one program (written before the forward and the
decode were exported apart), and an artifact of layout 2 whose forward
joins inside (one program, not its stages).

Tuning: ``max_batch=`` (largest coalesced batch, 128), ``max_wait_ms=``
(how long the oldest request may wait for the batch to fill, 2),
``max_pending=N`` (admission control: waveforms in flight; overload is
refused in-band), ``warmup=False`` (skip running every batch bucket before
the server binds; the first call of a shape builds the kernels). An
artifact exported at a fixed batch is its own single bucket: serve it with
``max_batch=`` that batch.

Departures from the JAX daemon:

- ``device=`` (new): the card (``cuda``) by default, as every entry point
  of the port; ``device=cpu`` runs the kernels' plain versions. Without a
  card and without ``device=cpu``, ``build`` raises. An artifact serves on
  devices of the kind it was exported for (``serve.load_pipeline``).
- Refused, with ``SystemExit``: ``compile_cache=`` (it persists XLA's
  compiles; an artifact of the port compiles nothing when it loads, and
  the kernels' libraries in ``build/kernels`` already persist across
  restarts), and under ``mesh_sp > 1`` the artifacts of older layouts
  (above). Only ``ckpt_dir=`` is searched for ``model_file=``.

Speak to it with ``stofnet_tpu_torch.serving.ServingClient`` (or JAX's,
or ``examples/serving_client.c``: the wire is the same). On SIGINT or
SIGTERM the daemon drains queued requests and prints its stats.
"""

from __future__ import annotations

import signal
import sys
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from stofnet_tpu_torch import resolve_device
from stofnet_tpu_torch.cli.export import (
    INT8_KEYS, apply_dtype_gate, load_calib, load_stack_cfg, parse_args,
    resolve_dtype, resolve_variables_and_overrides,
    resolve_zoo_variables_and_overrides,
)
from stofnet_tpu_torch.serve import (
    calibrate_int8, dequantize, encoded_window, load_pipeline,
    make_input_encoder, make_pipeline, parse_input_enc,
)
from stofnet_tpu_torch.parallel.mesh import (
    Mesh, config_mesh, local_devices, mesh_dims,
)
from stofnet_tpu_torch.parallel.seq import (
    HEATMAP, family_of, forward_kwargs, own_output, run_shards, shard_of,
)
from stofnet_tpu_torch.serving import (
    LengthRouter, ServingHost, batch_buckets, start_server,
)

_KNOWN_KEYS = frozenset({
    "artifact", "model_file", "ckpt_dir", "length", "th", "window_size",
    "max_echoes", "int8_calib", "int8_stack", "int8_eq_alpha",
    "int8_bias_correct", "host", "port", "max_batch", "max_wait_ms",
    "warmup", "mesh", "mesh_dp", "mesh_sp", "compile_cache", "max_pending",
    "num_features", "semi_global_scale", "num_blocks", "upsample_factor",
    "model", "dataset_kind", "rf_scale_factor", "sample_num", "fs",
    "n_layers", "dtype", "input_enc",
    "device",  # the port's own: cuda (default) or cpu
})
# keys of the JAX daemon the port refuses, and why
_REFUSED = {
    "compile_cache": ("it persists XLA's compiles: an artifact of the port "
                      "compiles nothing when it loads, and the kernels' "
                      "libraries in build/kernels persist across restarts"),
}


def build(args: Dict[str, Any]):
    """Resolve args to a ready (ServingHost, ServingTCPServer, port), every
    batch bucket warmed before the server binds. Separate from main() so
    tests and embedders can drive the daemon without signal handling."""
    unknown = set(args) - _KNOWN_KEYS
    if unknown:
        raise SystemExit(f"unknown argument(s) {sorted(unknown)}; "
                         f"supported: {sorted(_KNOWN_KEYS)}")
    for key, why in _REFUSED.items():
        if args.get(key):
            raise SystemExit(f"{key}= is not taken by the port: {why}")
    if args.get("artifact"):
        if args.get("model_file"):
            raise SystemExit("pass artifact= OR model_file=, not both")
        return _build_artifacts(args)
    model = str(args.get("model") or "stofnet").lower()
    if not args.get("model_file") and model != "gradpeak":
        raise SystemExit("artifact=<.pt2> or model_file=<ckpt> required")
    if not args.get("length"):
        raise SystemExit("length= is required with model_file= "
                         "(the serving contract's static length)")
    length = int(args["length"])
    enc = str(args.get("input_enc") or "f32")
    device = resolve_device(args.get("device"))
    mesh = _serving_mesh(args, device)
    if mesh is not None and length % mesh.sp:
        raise SystemExit(f"sample length {length} not divisible by "
                         f"mesh_sp={mesh.sp}")
    if mesh is not None:
        device = mesh.devices[0]
        _refuse_chunks(enc, mesh.sp)
    if model == "stofnet":
        state, overrides = resolve_variables_and_overrides(args)
    else:
        # the zoo from a checkpoint, the exporter's switch
        if any(args.get(k) for k in INT8_KEYS):
            raise SystemExit("int8 serving targets model=stofnet only")
        state, overrides = resolve_zoo_variables_and_overrides(args, model)
    th = args.get("th")
    pipe_kwargs = dict(
        window_size=int(args.get("window_size", 20)),
        threshold=None if th in (None, "Null") else float(th),
        max_echoes=int(args.get("max_echoes", 64)),
        int8_calib=load_calib(args), **load_stack_cfg(args))
    dtype = apply_dtype_gate(resolve_dtype(args), state, overrides,
                             length=length, model_name=model, device=device,
                             **pipe_kwargs)
    calib = pipe_kwargs.pop("int8_calib")
    if calib is not None:  # calibrated once, on the whole batch
        pipe_kwargs["int8_state"] = calibrate_int8(
            {k: v.to(device) for k, v in state.items()}, overrides, calib,
            **{k: v for k, v in pipe_kwargs.items() if k.startswith("int8")})

    def replica(where: torch.device):
        raw = make_pipeline(state, overrides, model_name=model, dtype=dtype,
                            device=where,
                            input_enc=None if enc == "f32" else enc,
                            **pipe_kwargs)
        raw.device = where
        return raw

    max_batch = int(args.get("max_batch", 128))
    pipeline, buckets = _mesh_adjust(replica, device, mesh, None, max_batch,
                                     enc)
    hostd = ServingHost(pipeline, length, max_batch=max_batch,
                        max_wait_ms=float(args.get("max_wait_ms", 2.0)),
                        buckets=buckets, max_pending=_max_pending(args))
    try:
        return _finish(hostd, args)
    except BaseException:
        hostd.close(timeout=5.0)
        raise


def _build_artifacts(args: Dict[str, Any]):
    """The daemon of ``artifact=`` (one path, or several comma-separated,
    routed by their lengths through ``LengthRouter``). Every host built
    is closed when the build fails."""
    raw = args["artifact"]
    paths = ([str(p) for p in raw] if isinstance(raw, (list, tuple))
             else [p.strip() for p in str(raw).split(",") if p.strip()])
    hosts: List[ServingHost] = []
    try:
        for p in paths:
            hosts.append(_artifact_host(p, args))
        if len(hosts) == 1:
            hostd = hosts[0]
        else:
            by_length: Dict[int, str] = {}
            for p, h in zip(paths, hosts):
                if h.length in by_length:
                    raise SystemExit(
                        f"artifacts {by_length[h.length]} and {p} both serve "
                        f"length {h.length}; lengths must be distinct to "
                        f"route by waveform length")
                by_length[h.length] = p
            hostd = LengthRouter({h.length: h for h in hosts})
        return _finish(hostd, args)
    except BaseException:
        for built in hosts:
            built.close(timeout=5.0)
        raise


def _artifact_host(path: str, args: Dict[str, Any]) -> ServingHost:
    """One ServingHost from one artifact: its static length is the routing
    key, and a fixed-batch artifact is its own single bucket. Under a mesh
    every replica loads the artifact on its device (``load_pipeline``
    moves it there); under sp each runs the forward program on its
    window, or, where the forward joins inside, its stages as its shard
    (``serve.PipelineExport``)."""
    raw = load_pipeline(path)
    mesh = _serving_mesh(args, raw.device)
    if mesh is not None and mesh.sp > 1:
        if raw.sp is None:
            raise SystemExit(
                f"{path} holds one program of the whole pipeline (written "
                f"before the forward and the decode were exported apart), "
                f"which decodes whole rows: export it again to serve it "
                f"under mesh_sp={mesh.sp}")
        if raw.sp == "joins" and not hasattr(raw, "shard"):
            raise SystemExit(
                f"{path} holds a forward that joins inside as one program "
                f"(layout {raw.format}, before such forwards were exported "
                f"as their stages), which runs whole rows: export it again "
                f"to serve it under mesh_sp={mesh.sp}")
        if raw.length % mesh.sp:
            raise SystemExit(f"sample length {raw.length} not divisible "
                             f"by mesh_sp={mesh.sp}")
        _refuse_chunks(raw.input_enc, mesh.sp)
    (spec,) = raw.in_specs
    length, batch = int(spec.shape[-1]), spec.shape[0]
    fixed = batch if isinstance(batch, int) else None
    max_batch = int(args.get("max_batch", fixed or 128))
    if fixed is not None and max_batch != fixed:
        raise SystemExit(
            f"{path} was exported at batch={fixed}; serve it with "
            f"max_batch={fixed} (or export it again with batch=b for a "
            f"batch-polymorphic artifact)")

    loaded = {raw.device: raw}  # a device's replicas share its programs

    def replica(where: torch.device):
        if where not in loaded:
            loaded[where] = load_pipeline(path, device=where)
        return loaded[where]

    pipeline, buckets = _mesh_adjust(
        replica, raw.device, mesh, (fixed,) if fixed is not None else None,
        max_batch, raw.input_enc)
    return ServingHost(pipeline, length, max_batch=max_batch,
                       max_wait_ms=float(args.get("max_wait_ms", 2.0)),
                       buckets=buckets, max_pending=_max_pending(args))


def _serving_mesh(args: Dict[str, Any], device: torch.device
                  ) -> Optional[Mesh]:
    """``mesh=True``'s replicas' mesh (no process group): dp of the cards,
    or dp replicas on the CPU, with JAX's refusals; None without
    ``mesh=``."""
    if not args.get("mesh"):
        return None
    dp, sp = mesh_dims(args)
    return config_mesh(args, devices=local_devices(device, dp, sp))


def _refuse_chunks(enc: Optional[str], sp: int) -> None:
    """JAX's refusal of ``s8c<n>`` under sp where sp does not divide n:
    its jit shards the chunk scales along their chunk axis over sp."""
    kind, n = parse_input_enc(enc)
    if kind == "s8c" and n % sp:
        raise SystemExit(
            f"input_enc={enc} under mesh_sp={sp} is refused: the s8c chunk "
            f"scales shard along their chunk axis over sp, so sp must "
            f"divide the chunk count {n} (JAX's jit refuses it too)")


def _mesh_adjust(replica: Callable, device: torch.device,
                 mesh: Optional[Mesh],
                 buckets: Optional[Sequence[int]], max_batch: int,
                 enc: str = "f32"
                 ) -> Tuple[Callable, Optional[Tuple[int, ...]]]:
    """The host's pipeline and buckets from ``replica(device) -> run``
    (``run.raw_call``, or ``run`` itself, takes the encoded inputs of
    ``input_enc=enc`` and returns the coords on ``run.device`` without
    waiting for them): ``replica(device)`` alone without a mesh; under
    one, a replica a mesh device, each batch split into dp equal slices,
    and only dp-divisible buckets (JAX's ``_mesh_adjust``; ``buckets``
    given is a fixed artifact's one bucket, its ``max_batch``). The host
    encodes each slice once; every slice is launched before any result is
    copied back, so the replicas' cards run together. Under sp > 1 the
    replicas of a dp row (devices ``d * sp .. d * sp + sp - 1``) each
    copy their shard's window of the slice's codes (``serve.
    encoded_window``: the codes of the window and the scales they need,
    never the row's) and dequantize it on their device, run
    ``run.heatmap`` on it (``parallel/seq.shard_of``), and the row's
    first replica joins the cropped heatmaps in order and decodes them
    (``run.decode``); the replicas that join inside their forward
    (``run.shard``: the int8 route, Zonzini, Kuleshov) run their shards on
    a thread each, joined in process. ``pipeline.copied`` counts the
    bytes of the inputs copied to the replicas, and holds the shapes of
    the last batch's copies."""
    if mesh is None:
        devices, dp, sp = [device], 1, 1
    else:
        dp, sp = mesh.dp, mesh.sp
        if max_batch % dp:
            raise SystemExit(f"max_batch={max_batch} must be divisible by "
                             f"the dp mesh size {dp}")
        if buckets is not None and dp > 1:
            raise SystemExit(
                f"an artifact exported at batch={max_batch} runs that "
                f"whole batch on each of the dp={dp} replicas and cannot "
                f"take a slice of {max_batch // dp} rows: export it with "
                f"batch=b (batch-polymorphic) to serve it on a mesh")
        if buckets is None:
            buckets = tuple(b for b in batch_buckets(max_batch)
                            if b % dp == 0)
        devices = list(mesh.devices)
    replicas = [replica(d) for d in devices]
    encode = make_input_encoder(enc)
    copied = {"bytes": 0, "shapes": []}
    lock = threading.Lock()

    def note(inputs) -> tuple:
        with lock:
            copied["bytes"] += sum(int(a.nbytes) for a in inputs)
            copied["shapes"].append(tuple(tuple(a.shape) for a in inputs))
        return inputs

    def window(n: int, coded, shard) -> torch.Tensor:
        """Replica n's window of a slice's codes, on its device."""
        a, b = shard.window or shard.own
        return dequantize(note(encoded_window(coded, enc, a, b)), enc, a,
                          shard.length, devices[n])

    def shards(i: int, coded) -> List[torch.Tensor]:
        """Slice i's shard outputs, launched, each on its own positions,
        in sp order: each replica's forward on its shard's window."""
        arch, length = replicas[i * sp].arch, coded[0].shape[-1]
        outs = []
        for k in range(sp):
            shard = shard_of(arch, length, sp, k, None)
            outs.append(own_output(arch, replicas[i * sp + k].heatmap(
                window(i * sp + k, coded, shard),
                **forward_kwargs(arch, shard)), shard))
        return outs

    def joined(coded) -> List[List[torch.Tensor]]:
        """The shard outputs of every slice of replicas that join inside
        their forward: every replica runs ``run.shard`` on its shard (its
        window of its slice, or Kuleshov's own samples) on a thread of its
        own, all submitted together, each dp row joined through one
        ``parallel/seq.ThreadExchange``."""
        arch = replicas[0].arch

        def one(n: int, exchange) -> torch.Tensor:
            c = coded[n // sp]
            shard = shard_of(arch, c[0].shape[-1], sp, n % sp, exchange)
            return replicas[n].shard(window(n, c, shard), shard)
        outs = run_shards(one, sp, rows=dp)
        return [outs[i * sp:(i + 1) * sp] for i in range(dp)]

    def pipeline(xb):
        with lock:
            copied["shapes"] = []
        coded = [encode(part) for part in np.split(xb, dp)]
        if sp == 1:
            outs = [getattr(rep, "raw_call", rep)(*note(c))
                    for rep, c in zip(replicas, coded)]
        else:  # every shard launched, then each slice joined and decoded
            launched = (joined(coded) if hasattr(replicas[0], "shard") else
                        [shards(i, c) for i, c in enumerate(coded)])
            outs = [_join(replicas[i * sp], row)
                    for i, row in enumerate(launched)]
        # the host takes numpy: the coords come back from the cards here
        return np.concatenate([o.cpu().numpy() for o in outs])

    for attr in ("route", "calls"):  # the first replica's
        if hasattr(replicas[0], attr):
            setattr(pipeline, attr, getattr(replicas[0], attr))
    pipeline.copied = copied
    return pipeline, None if buckets is None else tuple(buckets)


def _join(first: Callable, outs: List[torch.Tensor]) -> torch.Tensor:
    """A dp row's shard outputs, each on its own positions, joined on the
    device of the row's first replica and decoded there (``first.decode``):
    a heatmap's in sp order, Zonzini's and GradPeak's, whole on every
    shard, as the first shard's."""
    where = outs[0].device
    pred = (torch.cat([o.to(where) for o in outs], dim=-1)
            if family_of(first.arch) in HEATMAP else outs[0])
    return first.decode(pred)


def _max_pending(args: Dict[str, Any]) -> Optional[int]:
    """``max_pending=N``: admission limit (waveforms submitted but not
    yet resolved); unset is unbounded (the closed-loop default)."""
    v = args.get("max_pending")
    return None if v in (None, "Null") else int(v)


def _finish(hostd, args: Dict[str, Any]):
    """Warm every bucket (the first call builds the kernels), then bind."""
    if args.get("warmup", True):
        print("warming up (running every served batch shape)...",
              file=sys.stderr)
        hostd.warmup()
    server, _, port = start_server(
        hostd, (str(args.get("host", "127.0.0.1")), int(args.get("port", 0))))
    return hostd, server, port


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    hostd, server, port = build(args)
    lengths = getattr(hostd, "lengths", None) or (hostd.length,)
    print(f"serving waveforms of length(s) {list(lengths)} on "
          f"{args.get('host', '127.0.0.1')}:{port}; ctrl-c to stop",
          file=sys.stderr)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    print("draining...", file=sys.stderr)
    server.shutdown()
    server.server_close()
    hostd.close()
    print(f"served: {hostd.stats()}", file=sys.stderr)


if __name__ == "__main__":
    main()
