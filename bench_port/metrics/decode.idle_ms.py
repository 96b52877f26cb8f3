"""decode.idle_ms: ms a batch of the program's ``decode`` spans
(``ops/peaks.mask2coords``, inside ``pipe(x)``) during which no kernel,
copy or fill ran on the card (over the ``decode`` spans of the traced
slice, ``bench_port/spans.py``)."""

from bench_port import spans


def read(rec):
    return spans.idle_ms(rec, "decode")
