"""forward.mfu: the whole served step's share of the card's bf16 peak, %:
the forward's operations a waveform (the model file's ``forward_flops``)
times the waveforms whose coords reached the host a second, over the
H100's 989 TFLOP/s. Host clock, over the part of a traced run's window
after the profiler stopped (``Tracer.stopped``: a batch a tick), which
runs as an untraced window does; none off the card."""

from bench_port import counts


def read(rec):
    if rec.device.type != "cuda" or rec.slice_end is None:
        return None
    ticks, t = rec.slice_end
    batches, seconds = rec.window["batches"] - ticks, rec.window["end"] - t
    if batches <= 0 or seconds <= 0:
        return None
    flops = rec.model.forward_flops(rec.config)
    return (100.0 * flops * batches * rec.params["batch"] / seconds
            / counts.PEAK_BF16)
