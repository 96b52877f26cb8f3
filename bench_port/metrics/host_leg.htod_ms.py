"""host_leg.htod_ms: device ms a batch (the traced slice's ``pipe``
spans) of the copies from the host to the card (the frames, pageable),
by the trace's copy records."""


def read(rec):
    if rec.trace is None or not rec.trace.count("pipe"):
        return None
    ops = [o for o in rec.trace.ops if o.kind == "gpu_memcpy"
           and "HtoD" in o.name and rec.trace.start <= o.start
           < rec.trace.end]
    if not ops:
        return None
    return 1e3 * sum(o.end - o.start for o in ops) / rec.trace.count("pipe")
