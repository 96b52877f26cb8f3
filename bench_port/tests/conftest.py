"""The benchmark's own tests, on the CPU at tiny sizes (the card's run
skips here): ``python -m pytest bench_port/tests -q`` from the root."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the batch driver's parameters at a size the CPU runs in about a second
SHRINK = {"length": 800, "batch": 4, "pool": 2, "warmup": 1,
          "sample_batches": 2}
SEED = 2**31 + 7  # more than 32 signed bits hold, as a run's seed may


@pytest.fixture(scope="session")
def bench():
    from bench_port import harness
    return harness.load_json(harness.ROOT / "BENCHMARK.json")
