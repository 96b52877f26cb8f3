"""Hand-written CUDA kernels for Hopper (replaces ``stofnet_tpu/ops/pallas``).

Each kernel module holds the wrapper, its plain PyTorch version, a launch
counter (``launches``) and the layout of its weights that a pipeline
builds once (``sgb_weights``, ``stack_weights``) for the wrapper's
``*_prepared`` form. A wrapper given a CPU tensor runs the plain
version; given a CUDA tensor it launches the kernel or raises.
"""

from stofnet_tpu_torch.ops.kernels import conv_stack, sgb

KERNEL_MODULES = (sgb, conv_stack)


def reset_launch_counts() -> None:
    for mod in KERNEL_MODULES:
        mod.launches = 0
