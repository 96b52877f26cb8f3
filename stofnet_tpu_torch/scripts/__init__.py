"""Measurement scripts of the port (replaces ``scripts/`` of the JAX
package, one script at a time); each runs as
``python -m stofnet_tpu_torch.scripts.<name>``."""
