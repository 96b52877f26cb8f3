"""The span metrics (``bench_port/spans.py`` and its seven readers) on a
synthetic trace and synthetic program records with known idle and
launched times; None where the program keeps no records or has no
``recorded()``; and the accepted device readers unmoved by the program's
``stofnet.*`` events: user annotations with their shadows on the card's
timeline, typed as the profiler types them, and the host ``cpu_op``
events the program makes, typed and as a profiler that names no kinds
gives them (torch 2.11)."""

from types import SimpleNamespace

import pytest
import torch

from bench_port import harness
from bench_port.tests.test_bench_port_trace import CPU, CUDA, Event, Prof
from bench_port.trace import Trace
from stofnet_tpu_torch.utils import profiling
from stofnet_tpu_torch.utils.profiling import Record

T = 1_000_000  # us: the window opens 1 s after the set-up's first record
SPANS = ("host_leg.h2d_idle_ms", "forward.idle_ms", "decode.idle_ms",
         "plain_ops.span_ms", "decode.span_ms")
SETUP = ("setup.kernels_s", "setup.first_call_s")
ACCEPTED = ("plain_ops.device_ms", "decode.device_ms", "host_leg.htod_ms",
            "device.idle_share.batch", "sgb_dma_roofline",
            "conv_stack_roofline")


def device_events():
    """One ``pipe`` call, us from T: the copy 3-8 (h2d 1-10, idle 4); the
    forward 10-40 launches the conv stack 14-24, an elementwise kernel
    24-30, the SGB kernel 30-33 and a fill 33-35 (idle 9; plain ops 8);
    the decode 40-59 runs the max-pool 42-45 and a sort 45-55 (idle 6,
    device 13)."""
    def ev(name, device, start, dur, corr=0, kind=None):
        return Event(name, device, T + start, dur, corr, kind)

    return [
        ev("bench.window", CPU, 0, 100, kind="user_annotation"),
        ev("bench.pipe", CPU, 0, 60, kind="user_annotation"),
        ev("cudaMemcpyAsync", CPU, 2, 6, 11, "cuda_runtime"),
        ev("Memcpy HtoD (Pageable -> Device)", CUDA, 3, 5, 11, "gpu_memcpy"),
        ev("cudaLaunchKernel", CPU, 12, 1, 12, "cuda_runtime"),
        ev("conv_stack_kernel<bf16>", CUDA, 14, 10, 12, "kernel"),
        ev("cudaLaunchKernel", CPU, 15, 1, 13, "cuda_runtime"),
        ev("elementwise_kernel", CUDA, 24, 6, 13, "kernel"),
        ev("cudaLaunchKernel", CPU, 20, 1, 14, "cuda_runtime"),
        ev("sgb_contract_pool_dma_kernel<false>", CUDA, 30, 3, 14, "kernel"),
        ev("cudaMemsetAsync", CPU, 22, 1, 15, "cuda_runtime"),
        ev("Memset (Device)", CUDA, 33, 2, 15, "gpu_memset"),
        ev("cudaLaunchKernel", CPU, 41, 1, 16, "cuda_runtime"),
        ev("max_pool_forward_nchw<float>", CUDA, 42, 3, 16, "kernel"),
        ev("cudaLaunchKernel", CPU, 43, 1, 17, "cuda_runtime"),
        ev("sort_kernel", CUDA, 45, 10, 17, "kernel"),
        ev("bench.host_leg", CPU, 60, 30, kind="user_annotation"),
    ]


# the program's spans of that call: (name, start us from T, end, id, parent)
CALL = [("h2d", 1, 10, 2, 1), ("forward", 10, 40, 3, 1),
        ("decode", 40, 59, 4, 1), ("call", 1, 59, 1, None)]


def annotations(how="user_annotation"):
    """The program's spans as the profiler gives them: a user annotation
    on the host and its shadow on the card's timeline, or a host
    ``cpu_op`` alone (``how`` ``cpu_op``; ``untyped``, with no kind)."""
    out = []
    for name, a, b, _, _ in CALL:
        if how == "user_annotation":
            out.append(Event("stofnet." + name, CPU, T + a, b - a,
                             kind="user_annotation"))
            out.append(Event("stofnet." + name, CUDA, T + a + 1, b - a,
                             kind="gpu_user_annotation"))
        else:
            out.append(Event("stofnet." + name, CPU, T + a, b - a,
                             kind="cpu_op" if how == "cpu_op" else None))
    return out


def program_records():
    """The call's spans, and set-up stages before the window (s): a
    library loaded at 0.05-0.06, the first call at 0.1-0.9 holding a load
    at 0.2-0.5 that holds its build at 0.25-0.45."""
    recs = [Record("kernels.load", 50_000_000, 60_000_000, 10, None, 10),
            Record("kernels.build", 250_000_000, 450_000_000, 13, 12, 11),
            Record("kernels.load", 200_000_000, 500_000_000, 12, 11, 11),
            Record("first_call", 100_000_000, 900_000_000, 11, None, 11)]
    return recs + [Record(n, (T + a) * 1000, (T + b) * 1000, i, p, 1)
                   for n, a, b, i, p in CALL]


def rec_of(evs):
    cfg = harness.load_json(harness.HERE / "configs" /
                            "stofnet-armadillo.json")
    return SimpleNamespace(trace=Trace.from_profiler(Prof(evs)),
                           window={"seconds": 10.0, "end": 0.0},
                           config=cfg, params={"batch": 128},
                           device=torch.device("cuda"), slice_end=None)


@pytest.fixture
def keep(monkeypatch):
    """The program's records: the test's own."""
    def keep(recs):
        monkeypatch.setattr(profiling, "recorded", lambda: list(recs))
    return keep


def test_the_span_readers_read_known_times(keep):
    keep(program_records())
    rec = rec_of(device_events() + annotations())
    read = {m: harness.reader(m)(rec) for m in SPANS + SETUP}
    assert read == {
        "host_leg.h2d_idle_ms": pytest.approx(4e-3),
        "forward.idle_ms": pytest.approx(9e-3),
        "decode.idle_ms": pytest.approx(6e-3),
        "plain_ops.span_ms": pytest.approx(8e-3),
        "decode.span_ms": pytest.approx(13e-3),
        "setup.kernels_s": pytest.approx(0.31),
        "setup.first_call_s": pytest.approx(0.5)}
    # by span and by name alike
    assert read["plain_ops.span_ms"] == pytest.approx(
        harness.reader("plain_ops.device_ms")(rec))
    assert read["decode.span_ms"] == pytest.approx(
        harness.reader("decode.device_ms")(rec))


def test_spans_outside_the_window_and_per_batch(keep):
    """A second call's spans count per batch; spans outside the window,
    and the set-up's, not."""
    second = [Record(n, (T + a + 100) * 1000, (T + b + 100) * 1000,
                     i + 20, p and p + 20, 21) for n, a, b, i, p in CALL]
    keep(program_records() + second)
    rec = rec_of(device_events())
    # the second call lies past the window's end: not read
    assert harness.reader("forward.idle_ms")(rec) == pytest.approx(9e-3)
    inside = [Record(n, (T + a + 60) * 1000, (T + b + 60) * 1000 - 20_000,
                     i + 40, p and p + 40, 41)
              for n, a, b, i, p in CALL if n == "forward"]
    keep(program_records() + inside)  # a forward 70-80 us with no work
    assert harness.reader("forward.idle_ms")(rec) == pytest.approx(
        (9e-3 + 10e-3) / 2)
    assert harness.reader("plain_ops.span_ms")(rec) == pytest.approx(4e-3)


@pytest.mark.parametrize("how", ["none recorded", "no recorded()"])
def test_no_records_no_reading(monkeypatch, keep, how):
    if how == "none recorded":
        keep([])
    else:
        monkeypatch.delattr(profiling, "recorded")
    rec = rec_of(device_events())
    assert all(harness.reader(m)(rec) is None for m in SPANS + SETUP)


def test_no_trace_no_device_reading(keep):
    keep(program_records())
    rec = rec_of(device_events())
    rec.trace = None
    assert all(harness.reader(m)(rec) is None for m in SPANS)
    # without a trace, every set-up stage kept
    assert harness.reader("setup.first_call_s")(rec) == pytest.approx(0.5)
    assert harness.reader("setup.kernels_s")(rec) == pytest.approx(0.31)


@pytest.mark.parametrize("how", ["user_annotation", "cpu_op", "untyped"])
def test_the_accepted_readers_ignore_the_programs_events(how):
    plain, annotated = (rec_of(device_events()),
                        rec_of(device_events() + annotations(how)))
    for m in ACCEPTED:
        assert harness.reader(m)(annotated) == harness.reader(m)(plain), m
    assert harness.reader("plain_ops.device_ms")(plain) == pytest.approx(
        8e-3)
    assert harness.reader("device.idle_share.batch")(plain) == \
        pytest.approx(61.0)
    assert annotated.trace.breakdown() == plain.trace.breakdown()
