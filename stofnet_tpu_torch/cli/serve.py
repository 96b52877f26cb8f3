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
  the device it was exported for (``serve.load_pipeline``).
- Refused, with ``SystemExit``: ``compile_cache=`` (it persists XLA's
  compiles; an artifact of the port compiles nothing when it loads, and
  the kernels' libraries in ``build/kernels`` already persist across
  restarts) and ``mesh=`` (until ``parallel/mesh.py``). Only
  ``ckpt_dir=`` is searched for ``model_file=``.

Speak to it with ``stofnet_tpu_torch.serving.ServingClient`` (or JAX's,
or ``examples/serving_client.c``: the wire is the same). On SIGINT or
SIGTERM the daemon drains queued requests and prints its stats.
"""

from __future__ import annotations

import signal
import sys
import threading
from typing import Any, Dict, List, Optional

from stofnet_tpu_torch import resolve_device
from stofnet_tpu_torch.cli.export import (
    INT8_KEYS, apply_dtype_gate, load_calib, load_stack_cfg, parse_args,
    resolve_dtype, resolve_variables_and_overrides,
    resolve_zoo_variables_and_overrides,
)
from stofnet_tpu_torch.serve import (
    load_pipeline, make_input_encoder, make_pipeline,
)
from stofnet_tpu_torch.serving import (
    LengthRouter, ServingHost, start_server,
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
    "mesh": "it comes with the parallel/mesh.py slice (mesh serving)",
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
    device = resolve_device(args.get("device"))
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
    enc = str(args.get("input_enc") or "f32")
    raw = make_pipeline(state, overrides, model_name=model, dtype=dtype,
                        device=device,
                        input_enc=None if enc == "f32" else enc,
                        **pipe_kwargs)
    encode = make_input_encoder(enc)

    def pipeline(xb):
        # the host takes numpy: the coords come back from the card here
        return raw(*encode(xb)).cpu().numpy()

    pipeline.route, pipeline.calls = raw.route, raw.calls
    hostd = ServingHost(pipeline, length,
                        max_batch=int(args.get("max_batch", 128)),
                        max_wait_ms=float(args.get("max_wait_ms", 2.0)),
                        max_pending=_max_pending(args))
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
    key, and a fixed-batch artifact is its own single bucket."""
    raw = load_pipeline(path)
    (spec,) = raw.in_specs
    length, batch = int(spec.shape[-1]), spec.shape[0]
    fixed = batch if isinstance(batch, int) else None
    max_batch = int(args.get("max_batch", fixed or 128))
    if fixed is not None and max_batch != fixed:
        raise SystemExit(
            f"{path} was exported at batch={fixed}; serve it with "
            f"max_batch={fixed} (or export it again with batch=b for a "
            f"batch-polymorphic artifact)")

    def pipeline(xb):
        # the host takes numpy: the coords come back from the card here
        return raw(xb).cpu().numpy()

    return ServingHost(pipeline, length, max_batch=max_batch,
                       max_wait_ms=float(args.get("max_wait_ms", 2.0)),
                       buckets=(fixed,) if fixed is not None else None,
                       max_pending=_max_pending(args))


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
