"""The benchmark of the PyTorch and CUDA port (``stofnet_tpu_torch``) on
one NVIDIA H100; ``run.py`` is its command."""
