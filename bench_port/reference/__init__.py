"""The plain references that decide ``correct``: plain PyTorch and NumPy,
importing nothing of the program (``stofnet_tpu_torch``) and nothing of
JAX. One model file a model family, ``<model>.py``, named by a
configuration's ``model`` key (``harness.model_file``), holding its
``weights``, ``heatmap``, ``forward_flops`` and ``upsample_factor``;
``common.py`` holds what they and ``bench_port/check.py`` share."""
