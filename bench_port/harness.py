"""One run of one cell: set-up, the measured window, the check and the
result line. ``run.py`` is its command; the tests call :func:`run_cell`.

Everything that belongs to one configuration, cell or metric sits in a
file of its own under ``bench_port/``, found by the name that
``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the model, its architecture and source, the
  dtype, the decode, the route and its kernel launches a batch, the
  limits of the check;
- ``reference/<model>.py``, the model file of the configuration's
  ``model`` (a name of the program's model registry): ``weights(cfg,
  seed, device)``, the state dict drawn from the seed that both sides
  get; ``heatmap(state, x, cfg, quant=None)``, the plain f32 reference;
  ``forward_flops(cfg)``, the operations of one waveform's forward;
  ``upsample_factor(cfg)``, output positions an input sample; and, for
  ``control.py`` alone, ``int8_stack_layers(cfg)``, the stack convs that
  the program's int8 route may run in s8 (a file without it reads
  ``refused`` there);
- ``workloads/<cell>.json``: the configuration, the traffic, the chips,
  the traffic driver and its parameters;
- ``drivers/<driver>.py``: ``setup(ctx)``, ``measure(run)`` and
  ``samples(run, gen)`` (below);
- ``metrics/<metric>.py``: ``read(rec)``, the metric's value from the
  run's records (``rec.model`` is the model file), or None where it
  finds nothing to read.

A driver's ``setup`` builds the program under test from ``ctx`` (the
seed, the configuration, the parameters, the weights, the device), warms
up every shape the traffic uses and checks the route; ``measure`` runs
the window inside ``ctx.tracer.window()`` and returns its readings (a
dict: ``seconds``, ``attempted``, ``failed`` and what the metrics read);
``samples`` returns, once the window has closed, the sampled answers as
(frames, coords) pairs and the number of sampled requests never answered.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Any, Dict, List, Mapping, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "stofnet_tpu")
MODEL_FUNCTIONS = ("weights", "heatmap", "forward_flops", "upsample_factor")
# caches of the libraries the program may use, inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda"}


class Refused(RuntimeError):
    """The run cannot measure (no card, a wrong route, a bad cell file)."""


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def _module(kind: str, name: str, here: Path) -> ModuleType:
    path = here / kind / f"{name}.py"
    if not path.is_file():
        raise Refused(f"{name!r}: no file {path}")
    mod_name = f"bench_port_{kind}_" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, here: Path = HERE) -> ModuleType:
    return _module("drivers", name, here)


def reader(name: str, here: Path = HERE):
    return _module("metrics", name, here).read


def model_file(cfg: Mapping, here: Path = HERE) -> ModuleType:
    """The model file that the configuration's ``model`` names, with the
    functions the harness calls. A family that answers with positions
    has no ``heatmap`` to judge them by, and is refused so."""
    name = cfg.get("model")
    if name is None:
        raise Refused(f"configuration {cfg.get('name')!r} names no model")
    mod = _module("reference", name, here)
    lacks = [f for f in MODEL_FUNCTIONS
             if not callable(getattr(mod, f, None))]
    if lacks:
        raise Refused(f"model file {name}.py lacks {lacks}")
    return mod


def cell_files(name: str, bench: Mapping, here: Path = HERE):
    """The cell's entry in ``BENCHMARK.json``, its file and its
    configuration's file, checked against each other."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise Refused(f"no workload {name!r} in BENCHMARK.json")
    cell = load_json(here / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if cell[key] != entry[key]:
            raise Refused(f"{name}: {key} {cell[key]!r} in its file, "
                          f"{entry[key]!r} in BENCHMARK.json")
    cfg = load_json(here / "configs" / f"{cell['config']}.json")
    return entry, cell, cfg


def metrics_for(bench: Mapping, name: str, trace: bool) -> List[Mapping]:
    """The end-to-end metrics the cell reports (every cell, or those an
    entry's ``workloads`` lists), or with ``trace`` the per-layer ones
    whose ``workloads`` lists it."""
    if trace:
        return [m for m in bench["per_layer"] if name in m["workloads"]]
    return [m for m in bench["end_to_end"]
            if name in m.get("workloads", [name])]


def loaded_forbidden() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


@dataclass
class Context:
    """What a driver's ``setup`` gets."""
    seed: int
    seconds: float
    device: Any  # torch.device
    config: Dict[str, Any]
    params: Dict[str, Any]
    tracer: Any  # trace.Tracer
    weights: Dict[str, Any] = field(default_factory=dict)
    # log(phase): the seconds since the run's start, on standard error
    log: Any = lambda phase: None


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             t0: float, device=None, shrink: Optional[Mapping] = None,
             root: Path = ROOT, here: Path = HERE,
             log=lambda msg: print(msg, file=sys.stderr, flush=True)
             ) -> Dict[str, Any]:
    """One run; returns the result line's object. ``device`` None is the
    card, which the run insists on (``Refused`` without enough of them);
    the tests pass ``"cpu"``. ``shrink`` overrides parameters of the cell
    and keys of its configuration (``length``) for a run at a test's
    size."""
    bench = load_json(root / "BENCHMARK.json")
    entry, cell, cfg = cell_files(name, bench, here)
    model = model_file(cfg, here)
    for key, sub in CACHES.items():
        os.environ[key] = str(root / "build" / "bench_port" / sub)

    import torch

    torch.set_num_threads(1)  # few threads: the card does the work
    if device is None:
        if not torch.cuda.is_available():
            raise Refused("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < entry["chips"]:
            raise Refused(f"{torch.cuda.device_count()} card(s), the cell "
                          f"asks for {entry['chips']}")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    from bench_port import check, inputs
    from bench_port.trace import Tracer

    params = dict(cell["params"])
    cfg = dict(cfg)
    for key, value in (shrink or {}).items():
        (cfg if key in cfg else params)[key] = value
    tracer = Tracer(trace, device)

    def phase(what: str) -> None:
        log(f"setup {what} at {time.perf_counter() - t0:.3f} s")

    ctx = Context(int(seed), float(seconds), device, cfg, params, tracer,
                  log=phase)
    phase("imports")
    ctx.weights = model.weights(cfg, seed, device)
    phase("weights")
    drv = driver(cell["driver"], here)
    run = drv.setup(ctx)
    setup_s = time.perf_counter() - t0
    phase("done")
    try:
        window = drv.measure(run)
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        samples, missing = drv.samples(run, inputs.rng(seed, "sample"))
    finally:
        run.close()
    del run
    if device.type == "cuda":
        torch.cuda.empty_cache()
    found = loaded_forbidden()
    if found:
        raise Refused(f"modules of JAX or the JAX package loaded: {found}")
    result = check.checks(
        cfg, check.gaps(cfg, model, ctx.weights, samples, device), missing)
    # a CPU run (the tests') has no device trace to read
    on_card = tracer.trace if device.type == "cuda" else None
    rec = SimpleNamespace(window=window, setup_s=setup_s, config=cfg,
                          params=params, model=model, trace=on_card,
                          device=device, slice_end=tracer.stopped)
    metrics = {}
    for m in metrics_for(bench, name, trace):
        value = reader(m["name"], here)(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": entry["chips"] if device.type == "cuda" else 1,
           "memory_peak_bytes": int(peak)}
    out: Dict[str, Any] = {"correct": check.passed(result),
                           "attempted": int(window["attempted"]),
                           "failed": int(window["failed"]),
                           "metrics": metrics, "device": dev}
    if on_card is not None:
        dev["busy_s"] = on_card.busy_s
        dev["window_s"] = on_card.window_s
        out["breakdown"] = on_card.breakdown()
    out["checks"] = result
    for key, v in result.items():
        log(f"check {key} {v['value']} limit {v['limit']}")
    return out


def main(argv: Optional[List[str]] = None, t0: Optional[float] = None
         ) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        out = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace), t0=t0)
    except Refused as e:
        print(f"refused: {e}", file=sys.stderr, flush=True)
        return 3
    print(json.dumps(out), flush=True)
    return 0
