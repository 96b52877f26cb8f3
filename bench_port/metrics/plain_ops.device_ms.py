"""plain_ops.device_ms: device ms a batch of the forward's kernels other
than the SGB and conv-stack kernels (conv1, the expand conv, activations,
the upsample and add, the shuffle, casts and layout copies): the kernels
launched inside each of the benchmark's ``pipe`` spans before the
decode's first kernel (``trace.DECODE_FIRST``), over the spans that had
one."""

from bench_port.trace import DECODE_FIRST

KERNELS = ("sgb_contract_pool_dma_kernel", "conv_stack_kernel")


def read(rec):
    if rec.trace is None:
        return None
    ops, _, calls = rec.trace.split("pipe", DECODE_FIRST)
    ops = [o for o in ops if not any(k in o.name for k in KERNELS)]
    if not calls or not ops:
        return None
    return 1e3 * sum(o.end - o.start for o in ops) / calls
