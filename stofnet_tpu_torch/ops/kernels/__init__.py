"""Hand-written CUDA kernels for Hopper (replaces ``stofnet_tpu/ops/pallas``
and the two kernels of ``scripts/dma_probe.py``).

Each kernel module holds the wrapper, its plain PyTorch version, one
launch counter per kernel (named in its ``COUNTERS``) and the layout of
its weights that a pipeline builds once (``sgb_dma_weights``,
``stack_weights``) for the wrapper's ``*_prepared`` form. A wrapper given
a CPU tensor runs the plain version; given a CUDA tensor it launches the
kernel or raises. ``sgb`` and ``sgb_dma`` share one source,
``csrc/sgb_contract_pool_dma.cu``: its serving instantiation (counted in
``sgb_dma``) and kernel A (counted in ``sgb``).
"""

from stofnet_tpu_torch.ops.kernels import conv_stack, dma_probe, sgb, sgb_dma

KERNEL_MODULES = (sgb, conv_stack, sgb_dma, dma_probe)
# the CUDA sources under csrc/ (chip_smoke.py builds them all at once)
SOURCES = ("conv_stack", "sgb_contract_pool_bwd", "sgb_contract_pool_dma",
           "dma_probe")


def reset_launch_counts() -> None:
    for mod in KERNEL_MODULES:
        for name in mod.COUNTERS:
            setattr(mod, name, 0)
