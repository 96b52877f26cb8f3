"""Host utilities of the port (replaces the parts of ``stofnet_tpu/utils``
that the port's CLIs need)."""
