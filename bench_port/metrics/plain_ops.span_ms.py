"""plain_ops.span_ms: device ms a batch of the forward's kernels and
fills other than the SGB and conv-stack kernels: those launched inside
the program's ``forward`` spans, over the ``forward`` spans of the traced
slice (``bench_port/spans.py``)."""

from bench_port import spans

KERNELS = ("sgb_contract_pool_dma_kernel", "conv_stack_kernel")


def read(rec):
    return spans.launched_ms(rec, "forward", skip=KERNELS)
