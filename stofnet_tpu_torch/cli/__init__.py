"""Command-line entry points of the port (replaces ``stofnet_tpu/cli`` as
far as the port goes: the serving daemon and the helpers it shares with
the exporter)."""
