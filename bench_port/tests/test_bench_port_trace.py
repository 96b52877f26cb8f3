"""The trace's reading: device activity by kind and by the span it was
launched in, the busy union, the idle gaps and the breakdown, on events
as the profiler gives them with and without their activity type."""

import pytest
import torch

from bench_port.trace import Trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Event:
    def __init__(self, name, device, start_us, dur_us, corr=0, kind=None):
        self._v = (name, device, int(start_us * 1000), int(dur_us * 1000),
                   corr)
        if kind is not None:
            self.activity_type = lambda: kind

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


def events(typed):
    def ev(name, device, start, dur, corr=0, kind=None):
        return Event(name, device, start, dur, corr, kind if typed else None)

    return [
        ev("bench.window", CPU, 0, 100, kind="user_annotation"),
        ev("bench.pipe", CPU, 0, 50, kind="user_annotation"),
        ev("cudaMemcpyAsync", CPU, 1, 5, 11, "cuda_runtime"),
        ev("Memcpy HtoD (Pageable -> Device)", CUDA, 2, 4, 11, "gpu_memcpy"),
        ev("cudaLaunchKernel", CPU, 10, 1, 12, "cuda_runtime"),
        ev("conv_stack_kernel(bf16)", CUDA, 12, 20, 12, "kernel"),
        ev("bench.pipe", CUDA, 2, 30, 0, "gpu_user_annotation"),
        ev("aten::conv1d", CPU, 9, 3, 12, "cpu_op"),
        ev("cudaLaunchKernel", CPU, 41, 1, 13, "cuda_runtime"),
        ev("sort_kernel", CUDA, 42, 8, 13, "kernel"),
        ev("cudaLaunchKernel", CPU, 35, 1, 16, "cuda_runtime"),
        ev("max_pool_forward_nchw<float>", CUDA, 36, 4, 16, "kernel"),
        ev("bench.host_leg", CPU, 60, 30, kind="user_annotation"),
        ev("cudaMemsetAsync", CPU, 61, 1, 14, "cuda_runtime"),
        ev("Memset (Device)", CUDA, 70, 10, 14, "gpu_memset"),
        ev("late_kernel", CUDA, 120, 5, 15, "kernel"),  # after the window
    ]


class Prof:
    def __init__(self, evs):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type("K", (), {})()
        self.profiler.kineto_results.events = lambda: evs


@pytest.mark.parametrize("typed", [True, False])
def test_trace_reads_kinds_spans_and_gaps(typed):
    t = Trace.from_profiler(Prof(events(typed)))
    assert [o.kind for o in t.ops] == ["gpu_memcpy", "kernel", "kernel",
                                       "kernel", "gpu_memset", "kernel"]
    assert t.window_s == pytest.approx(100e-6)
    # busy: 2-6, 12-32, 36-40, 42-50, 70-80 us
    assert t.busy_s == pytest.approx(46e-6)
    # each op by the span its launch was in (none recorded: unknown)
    assert [t.span_at(o.launched) for o in t.ops] == [
        "pipe", "pipe", "pipe", "pipe", "host_leg", "unknown"]
    assert t.count("pipe") == 1
    assert [t.span_at(u * 1e-6) for u in (1, 55, 61)] == [
        "pipe", "loop", "host_leg"]
    gaps = t.idle_gaps()
    assert gaps["pipe"] == pytest.approx(14e-6)  # 0-2, 6-12, 32-36, 40-42
    # 50-70 (its middle in host_leg, 60-90) and 80-100
    assert gaps["host_leg"] == pytest.approx(40e-6)
    assert sum(gaps.values()) == pytest.approx(t.window_s - t.busy_s)
    top = t.breakdown()["device_ops"]
    assert top[0] == ["conv_stack_kernel(bf16)", pytest.approx(20e-6)]
    assert "late_kernel" not in dict(top)


def test_the_slice_ends_at_a_tick_and_the_rate_after_it_is_read():
    from types import SimpleNamespace

    from bench_port import counts, harness
    from bench_port.reference import stofnet
    from bench_port.trace import Tracer

    tracer = Tracer(True, torch.device("cpu"), traced_s=0.0)
    with tracer.window():
        for _ in range(3):
            tracer.tick()
    assert tracer.stopped[0] == 1 and tracer.ticks == 3
    assert tracer.trace.window_s > 0

    cfg = harness.load_json(harness.HERE / "configs" /
                            "stofnet-armadillo.json")
    mfu = harness.reader("forward.mfu")
    rec = SimpleNamespace(device=torch.device("cuda"), slice_end=(10, 100.0),
                          window={"batches": 110, "end": 102.0},
                          config=cfg, params={"batch": 128}, model=stofnet)
    flops = stofnet.forward_flops(cfg)
    assert mfu(rec) == pytest.approx(
        100.0 * flops * 100 * 128 / 2.0 / counts.PEAK_BF16)
    rec.slice_end = (110, 102.0)  # the window ended inside the slice
    assert mfu(rec) is None
    rec.device = torch.device("cpu")
    assert mfu(rec) is None
