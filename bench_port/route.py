"""The route guard: the kernels each call of a configuration's route
launches, read from the program's launch counters
(``stofnet_tpu_torch.ops.kernels``), against what the configuration's
file states."""

from __future__ import annotations

from typing import Dict


def expected_launches(ctx) -> Dict[str, int]:
    """Kernel launches a batch: the configuration's on the card; none on
    the CPU, where the kernels' plain versions run."""
    per = ctx.config["launches_per_batch"]
    return dict(per) if ctx.device.type == "cuda" else dict.fromkeys(per, 0)


def launch_counts() -> Dict[str, int]:
    from stofnet_tpu_torch.ops.kernels import KERNEL_MODULES
    return {f"{m.__name__.rsplit('.', 1)[1]}.{c}": getattr(m, c)
            for m in KERNEL_MODULES for c in m.COUNTERS}


def check_launches(before: Dict[str, int], per: Dict[str, int],
                   calls: int, what: str) -> None:
    """Raise unless each counter rose by its launches a call times
    ``calls`` since ``before``."""
    after = launch_counts()
    rose = {k: after[k] - before[k] for k in per}
    want = {k: v * calls for k, v in per.items()}
    if rose != want:
        raise RuntimeError(f"route guard, {what}: kernel launches {rose} "
                           f"over {calls} calls, the configuration's route "
                           f"launches {want}")
