"""setup.first_call_s: the self time, in seconds, of the pipeline's first
call in the run's set-up (the program's ``first_call`` span: the custom
ops' first dispatch and whatever else runs once): its duration less the
kernel-library spans inside it (``setup.kernels_s``'s), host clock. The
last such span before the window: in a process that runs one cell the
only one, in one that ran others first this run's
(``bench_port/spans.py``)."""

from bench_port import spans


def read(rec):
    found = spans.setup(rec)
    first = [r for r in found or () if r.name == "first_call"]
    if not first:
        return None
    call = max(first, key=lambda r: r.start)
    inside = sum(r.end - r.start for r in found
                 if r.parent == call.id and r.name in spans.KERNEL_SPANS)
    return (call.end - call.start - inside) * 1e-9
