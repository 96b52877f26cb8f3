"""host_leg.h2d_idle_ms: ms a batch of the program's ``h2d`` spans (the
frames' copy to the card and their cast, inside ``pipe(x)``) during
which no kernel, copy or fill ran on the card, over the ``h2d`` spans of
the traced slice (``bench_port/spans.py``)."""

from bench_port import spans


def read(rec):
    return spans.idle_ms(rec, "h2d")
