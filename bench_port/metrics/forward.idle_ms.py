"""forward.idle_ms: ms a batch of the program's ``forward`` spans (the
route's forward, inside ``pipe(x)``) during which no kernel, copy or
fill ran on the card: the host's launches falling behind the card (for
the ``forward`` spans of the traced slice, ``bench_port/spans.py``)."""

from bench_port import spans


def read(rec):
    return spans.idle_ms(rec, "forward")
