"""sgb_dma_roofline: the SGB kernel's share of its roofline, %: the least
time of its calls at the card's peaks (``counts.sgb_dma_call``, bound by
operations at B=128, L=8000) over their device time in the trace."""

from bench_port import counts

KERNEL = "sgb_contract_pool_dma_kernel<false>"


def read(rec):
    if rec.trace is None:
        return None
    ops = rec.trace.ops_named(KERNEL)
    if not ops:
        return None
    least, _ = counts.least_s(*counts.sgb_dma_call(
        rec.params["batch"], rec.config["length"]))
    return 100.0 * least * len(ops) / sum(o.end - o.start for o in ops)
