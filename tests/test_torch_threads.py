"""The torch thread pool of a pytest-xdist worker (used by the port's test
files that start gloo ranks).

Under ``pytest -n N`` every worker process, and every rank that a test of
it spawns (``parallel/mesh.launch`` splits its parent's pool between the
ranks), would otherwise take a pool of one thread a core: N pools on the
cores, whose OpenMP threads spin while they wait, slowed a two-rank
``scripts/dp_check.py`` run from 9 s alone to about 110 s beside five
busy workers on an 8-core host. :func:`share_cores` gives each worker
its share of the cores; a file run alone keeps them all.
"""

import os

import torch


def worker_threads(cores: int, workers: int) -> int:
    """A worker's threads: its share of ``cores`` among ``workers``."""
    return max(1, cores // max(1, workers))


def share_cores() -> int:
    """Set this process's torch thread pool to its worker's share of the
    cores it may run on; returns the thread count."""
    n = worker_threads(len(os.sched_getaffinity(0)),
                       int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", 1)))
    torch.set_num_threads(n)
    return n


share_cores()


def test_worker_threads_share_the_cores():
    assert [worker_threads(8, w) for w in (1, 2, 6, 8, 16)] == [8, 4, 1, 1, 1]
    assert torch.get_num_threads() == worker_threads(
        len(os.sched_getaffinity(0)),
        int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", 1)))
