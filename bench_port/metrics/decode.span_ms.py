"""decode.span_ms: device ms a batch of the kernels and fills launched
inside the program's ``decode`` spans (``ops/peaks.mask2coords``), over
the ``decode`` spans of the traced slice (``bench_port/spans.py``).
``decode.device_ms`` found by the program's span, not by the decode's
first kernel's name."""

from bench_port import spans


def read(rec):
    return spans.launched_ms(rec, "decode")
