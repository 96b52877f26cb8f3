"""setup.kernels_s: seconds of the run's set-up in the program's kernel
libraries: its ``kernels.load`` spans (a library's first load, its nvcc
build included where the checkout had none) and any ``kernels.build``
outside one (``bench_port/spans.py``), host clock."""

from bench_port import spans


def read(rec):
    found = spans.setup(rec)
    if found is None:
        return None
    ids = {r.id for r in found if r.name in spans.KERNEL_SPANS}
    return sum(((r.end - r.start) * 1e-9 for r in found
                if r.name in spans.KERNEL_SPANS and r.parent not in ids), 0.0)
