"""The program's spans (``stofnet_tpu_torch/utils/profiling.py``), on the
CPU: no record and one shared no-op without a profiler; under
``torch.profiler`` one serving call as the root span ``call`` holding
``h2d``, ``forward`` and ``decode`` under one call id, on each route and
entry (module, fused, int8, a zoo model, an s8c-encoded input, an sp
shard); each record on the clock of its profiler event, which casts no
shadow on the card's timeline; the
set-up stages (``first_call``, the kernel libraries' build and load)
recorded without a profiler and nested; the buffer bounded; the spans in
``StepTraceProfiler``'s Chrome trace.

Weights: the modules' own initialization under a fixed seed (what a
span records does not depend on them)."""

import json
import os
import stat
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from stofnet_tpu_torch.data.synthetic import gate_batch
from stofnet_tpu_torch.models import StofNet, build_model
from stofnet_tpu_torch.ops.kernels import _build
from stofnet_tpu_torch.parallel import seq
from stofnet_tpu_torch.serve import make_input_encoder, make_pipeline
from stofnet_tpu_torch.utils import profiling

L = 800
CALL = {"call", "h2d", "forward", "decode"}
# a zoo model at a small size (tests/test_torch_zoo_models.py's)
ZOO = dict(dataset_kind="chirp", upsample_factor=4, sample_num=200,
           rf_scale_factor=4, fs=1e6)


def _state(**overrides):
    torch.manual_seed(0)
    model = StofNet(device="cpu", **overrides)
    return {k: v.detach() for k, v in model.state_dict().items()}


def _frames(batch=2, length=L, seed=3):
    return gate_batch(batch, length, np.random.default_rng(seed))


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _since(before):
    """The records kept after the ``before`` snapshot of ``recorded()``."""
    seen = {r.id for r in before}
    return [r for r in profiling.recorded() if r.id not in seen]


def _assert_one_call(recs, names=CALL, root="call"):
    """``recs`` is one root span ``root`` holding the rest, every record
    under the root's id, each child inside the root's interval."""
    assert sorted(r.name for r in recs) == sorted(names)
    top = next(r for r in recs if r.name == root)
    assert top.parent is None and top.call == top.id
    for r in recs:
        assert r.call == top.id
        if r is not top:
            assert r.parent == top.id
            assert top.start <= r.start <= r.end <= top.end


def _pipelines():
    """(name, pipeline, its inputs) of each route and input kind."""
    x = _frames()
    torch.manual_seed(0)
    zoo, _ = build_model("espcn", device="cpu", **ZOO)
    zoo_state = {k: v.detach() for k, v in zoo.state_dict().items()}
    kw = dict(max_echoes=8, device="cpu")
    return {
        "fused": (make_pipeline(_state(), {}, **kw), (x,)),
        "module": (make_pipeline(_state(num_features=32),
                                 {"num_features": 32}, **kw), (x,)),
        "int8": (make_pipeline(_state(), {}, int8_calib=x, **kw), (x,)),
        "zoo": (make_pipeline(zoo_state, ZOO, model_name="espcn", **kw),
                (_frames(length=ZOO["sample_num"] * 4),)),
        "s8c": (make_pipeline(_state(), {}, input_enc="s8c", **kw),
                make_input_encoder("s8c")(x)),
    }


@pytest.fixture(scope="module")
def pipelines():
    pipes = _pipelines()
    for pipe, inputs in pipes.values():
        pipe(*inputs)  # the first call, a set-up stage
    return pipes


def test_no_profiler_no_record(pipelines):
    assert profiling.span("call") is profiling.span("h2d")
    with profiling.span("call"):
        pass
    pipe, (x,) = pipelines["fused"]
    before = profiling.recorded()
    pipe(x)
    pipe.decode(pipe.heatmap(x))
    assert profiling.recorded() == before
    assert not profiling.enabled()


@pytest.mark.parametrize("route", ["fused", "module", "int8", "zoo", "s8c"])
def test_a_call_under_the_profiler_is_one_span_tree(pipelines, route):
    pipe, inputs = pipelines[route]
    calls = dict(pipe.calls)
    before = profiling.recorded()
    with _cpu_profile():
        out = pipe(*inputs)
    _assert_one_call(_since(before))
    assert out.shape[0] == inputs[0].shape[0]
    assert sum(pipe.calls.values()) == sum(calls.values()) + 1
    if route in ("fused", "module", "int8"):
        assert pipe.route(L) == route
    # the forward and the decode alone are roots of their own
    before = profiling.recorded()
    x = inputs[0] if route != "s8c" else pipelines["fused"][1][0]
    with _cpu_profile():
        pipe.decode(pipe.heatmap(x))
    recs = _since(before)
    _assert_one_call([r for r in recs if r.name != "decode"],
                     {"heatmap", "h2d", "forward"}, root="heatmap")
    (dec,) = [r for r in recs if r.name == "decode"]
    assert dec.parent is None and dec.call == dec.id


def test_an_sp_shard_is_one_span_tree(pipelines):
    """``pipe.shard`` on an sp=2 shard's window of the int8 route (its
    exchange joins nothing here: a span test, not a numerical one)."""
    pipe, (x,) = pipelines["int8"]

    class Unjoined:
        def max(self, t):
            return t

    shard = seq.shard_of(pipe.arch, L, 2, 1, Unjoined())
    a, b = shard.window
    before = profiling.recorded()
    with _cpu_profile():
        out = pipe.shard(x[..., a:b], shard)
    _assert_one_call(_since(before), {"call", "h2d", "forward"})
    assert out.shape[-1] == (shard.own[1] - shard.own[0]) * 4


def _events(prof):
    """The program's profiler events, by name, in start order."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(profiling.PREFIX):
            out.setdefault(e.name()[len(profiling.PREFIX):], []).append(e)
    return {k: sorted(v, key=lambda e: e.start_ns()) for k, v in out.items()}


def test_records_share_the_profilers_clock(pipelines):
    """Each record brackets its event (taken just outside it) and lies
    within 50 us of it at both ends; a try preempted between the two
    clocks' readings is tried again, up to three times."""
    pipe, (x,) = pipelines["fused"]
    with _cpu_profile():  # the profiler's first event comes late
        pipe(x)
    worst = []
    for _ in range(3):
        before = profiling.recorded()
        with _cpu_profile() as prof:
            pipe(x)
            pipe.heatmap(x)
        recs, events = _since(before), _events(prof)
        gaps = []
        for name in ("call", "h2d", "forward", "decode", "heatmap"):
            mine = sorted((r for r in recs if r.name == name),
                          key=lambda r: r.start)
            theirs = events[name]
            assert len(mine) == len(theirs) >= 1
            for r, e in zip(mine, theirs):
                end = e.start_ns() + e.duration_ns()
                assert r.start <= e.start_ns() and end <= r.end
                gaps += [e.start_ns() - r.start, r.end - end]
        worst.append(max(gaps))
        if worst[-1] <= 50_000:
            break
    assert min(worst) <= 50_000, worst


def test_the_spans_are_host_events_without_a_shadow(pipelines):
    """The program's events are the host's alone, of the profiler's
    ``cpu_op`` kind where it names kinds: no ``gpu_user_annotation``
    shadow on the card's timeline, which a reader of a profiler that
    names no kinds would count as a kernel."""
    pipe, (x,) = pipelines["fused"]
    with _cpu_profile() as prof:
        pipe(x)
    ours = [e for e in prof.profiler.kineto_results.events()
            if e.name().startswith(profiling.PREFIX)]
    assert sorted(e.name() for e in ours) == sorted(
        profiling.PREFIX + n for n in CALL)
    for e in ours:
        assert e.device_type() == torch.autograd.DeviceType.CPU
        kind = getattr(e, "activity_type", None)
        assert kind is None or str(kind()) == "cpu_op"


def test_set_up_stages_record_without_a_profiler_and_nest():
    assert not profiling.enabled()
    before = profiling.recorded()
    with profiling.once("outer"):
        with profiling.span("call"):  # no profiler: not kept
            with profiling.once("inner"):
                pass
    outer, inner = sorted(_since(before), key=lambda r: r.start)
    assert (outer.name, inner.name) == ("outer", "inner")
    assert outer.parent is None and outer.call == outer.id
    assert inner.parent == outer.id and inner.call == outer.id
    assert outer.start <= inner.start <= inner.end <= outer.end


def test_a_pipelines_first_call_is_a_set_up_stage():
    pipe = make_pipeline(_state(), {}, max_echoes=8, device="cpu",
                         input_enc="s8c")
    x = _frames()
    before = profiling.recorded()
    pipe.heatmap(x)  # any entry's first call, the encoded one's shared
    pipe(*make_input_encoder("s8c")(x))
    pipe.decode(pipe.heatmap(x))
    (first,) = _since(before)
    assert first.name == "first_call" and first.parent is None


def test_kernel_builds_and_loads_are_set_up_stages(tmp_path, monkeypatch):
    """``_build.load`` of a library not loaded yet: ``kernels.load``
    holding ``kernels.build`` (a stand-in compiler writes the library; a
    stand-in ``ctypes.CDLL`` loads it); loaded, no record."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then : > "$2"; fi; shift\n'
                    'done\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    (tmp_path / "probe.cu").write_text("// stand-in\n")
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    lib = types.SimpleNamespace(kernel_error_string=types.SimpleNamespace())
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: lib)
    before = profiling.recorded()
    assert _build.load("probe", {}) is lib
    assert os.path.isfile(tmp_path / "build" / "libprobe.so")
    load, build = sorted(_since(before), key=lambda r: r.start)
    assert (load.name, build.name) == ("kernels.load", "kernels.build")
    assert load.parent is None and build.parent == load.id
    before = profiling.recorded()
    assert _build.load("probe", {}) is lib
    assert _build.build_all(["probe"]) == {}  # built: no compiler
    assert _since(before) == []


def test_the_buffer_is_bounded():
    with profiling.once("kept"):
        pass
    with _cpu_profile():
        for _ in range(profiling.MAX_SPANS + 100):
            with profiling.span("tick"):
                pass
    recs = profiling.recorded()
    ticks = [r for r in recs if r.name == "tick"]
    assert len(ticks) == profiling.MAX_SPANS
    assert len(recs) <= profiling.MAX_SPANS + profiling.MAX_ONCE
    assert any(r.name == "kept" for r in recs)


def test_the_spans_appear_in_the_drivers_chrome_trace(pipelines, tmp_path):
    pipe, (x,) = pipelines["fused"]
    prof = profiling.StepTraceProfiler(str(tmp_path), steps=2)
    for _ in range(3):
        pipe(x)
        prof.step()
    prof.close()
    names = {e.get("name") for e in
             json.loads(prof.path.read_text())["traceEvents"]}
    assert {"stofnet." + n for n in CALL} <= names
