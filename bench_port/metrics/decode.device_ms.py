"""decode.device_ms: device ms a batch of the decode
(``ops/peaks.mask2coords``): the kernels launched inside each of the
benchmark's ``pipe`` spans from the decode's first kernel on
(``trace.DECODE_FIRST``, the NMS max-pool), over the spans that had one."""

from bench_port.trace import DECODE_FIRST


def read(rec):
    if rec.trace is None:
        return None
    _, ops, calls = rec.trace.split("pipe", DECODE_FIRST)
    if not calls:
        return None
    return 1e3 * sum(o.end - o.start for o in ops) / calls
