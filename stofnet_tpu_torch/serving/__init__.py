"""Serving runtime: dynamic batch coalescing over the serving pipeline, in
process and over TCP (a copy of ``stofnet_tpu/serving``; numpy and the
standard library only).

Concurrent clients submit single waveforms or small batches; the host
coalesces them into large batches of a few fixed sizes, where the card
earns its throughput, and fans the results back out per request. The wire
protocol is the JAX package's byte for byte, so its ``ServingClient`` and
``examples/serving_client.c`` talk to the port's daemon unchanged.
"""

from stofnet_tpu_torch.serving.host import (
    Overloaded, ServingHost, batch_buckets,
)
from stofnet_tpu_torch.serving.router import LengthRouter
from stofnet_tpu_torch.serving.tcp import (
    WIRE_CODES, ServingClient, ServingTCPServer, decode_payload,
    encode_rows, start_server,
)

__all__ = [
    "ServingHost",
    "Overloaded",
    "LengthRouter",
    "batch_buckets",
    "ServingClient",
    "ServingTCPServer",
    "start_server",
    "WIRE_CODES",
    "encode_rows",
    "decode_payload",
]
