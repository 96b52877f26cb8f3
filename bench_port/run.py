"""The port's benchmark, one run of one cell on one NVIDIA H100::

    python3 bench_port/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout. It builds the cell's program from the seed
(weights on the card, host frames), warms up every shape the cell uses,
measures for ``--seconds``, checks the window's answers against the plain
reference (``bench_port/reference``), and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
ones), ``device``, with ``--trace 1`` ``breakdown``, and ``checks``, each
number compared beside its limit, which also end standard error. Without
a card, or with fewer than the cell asks for, it exits 3 and prints no
result. ``harness.py`` says where each cell, configuration and metric
lives.
"""

import sys
import time

T0 = time.perf_counter()

from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench_port import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t0=T0))
