"""The plain references that decide ``correct``: plain PyTorch and NumPy,
importing nothing of the program (``stofnet_tpu_torch``) and nothing of
JAX. One module a model family; ``heatmap`` and ``served_gaps`` are what
``bench_port/check.py`` calls."""
