"""Length routing: one daemon, one port, N waveform lengths (a copy of
``stofnet_tpu/serving/router.py``).

Production RF frames come at per-probe lengths, and a serving pipeline is
built for one static length. ``LengthRouter`` composes per-length
``ServingHost``s behind the single host surface the TCP front already
speaks: requests route by ``x.shape[-1]``, each length keeps its own
dynamic-batching dispatcher (batches of different lengths cannot
coalesce), and a length no host serves raises with the served set, which
the TCP handler reports to the client without dropping the connection.
"""

from __future__ import annotations

from concurrent.futures import Future
from typing import Any, Dict, Optional

import numpy as np

from stofnet_tpu_torch.serving.host import ServingHost


class LengthRouter:
    """``ServingHost``-shaped facade over per-length hosts.

    ``hosts``: {length: ServingHost} — each host's own ``length`` must
    match its key.
    """

    def __init__(self, hosts: Dict[int, ServingHost]):
        if not hosts:
            raise ValueError("LengthRouter needs at least one host")
        for length, host in hosts.items():
            if int(length) != host.length:
                raise ValueError(f"router key {length} != host length "
                                 f"{host.length}")
        self._hosts = {int(length): host for length, host in hosts.items()}

    @property
    def lengths(self) -> tuple:
        return tuple(sorted(self._hosts))

    def _route(self, x: np.ndarray) -> ServingHost:
        length = int(np.asarray(x).shape[-1])
        host = self._hosts.get(length)
        if host is None:
            raise ValueError(f"no host serves waveform length {length} "
                             f"(served lengths: {self.lengths})")
        return host

    def submit(self, x: np.ndarray) -> Future:
        return self._route(x).submit(x)

    def infer(self, x: np.ndarray, timeout: Optional[float] = None):
        return self.submit(x).result(timeout)

    def warmup(self) -> None:
        for host in self._hosts.values():
            host.warmup()

    def stats(self) -> Dict[str, Any]:
        per = {length: host.stats() for length, host in self._hosts.items()}
        agg: Dict[str, Any] = {"per_length": per}
        for key in ("requests", "waveforms", "batches", "padded", "errors",
                    "rejected", "pending"):
            agg[key] = sum(s[key] for s in per.values())
        agg["occupancy"] = (agg["waveforms"] / agg["padded"]
                            if agg["padded"] else 0.0)
        return agg

    def close(self, timeout: Optional[float] = 60.0) -> None:
        for host in self._hosts.values():
            host.close(timeout)

    def __enter__(self) -> "LengthRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
