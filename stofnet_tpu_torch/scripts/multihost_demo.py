"""Multi-process training over ``torch.distributed`` (replaces
``scripts/multihost_demo.py``)::

    python -m stofnet_tpu_torch.scripts.multihost_demo

Launcher mode starts 2 worker processes. Each joins one process group
through ``parallel.init_distributed`` (gloo, a ``file://`` store in a
temporary directory: no port is fixed), feeds only its local shard of
each global batch, and runs the amp train step
(``train.make_train_step(amp=True, mesh=...)``) of a small StofNet for
4 steps. The workers must report the same finite loss trajectory
(gathered and compared inside the job, then by the launcher), equal to
a single-process run of the same global batches within 5e-3 (the JAX
demo's bound). Prints one JSON line; writes no file.

Worker mode (internal): ``... multihost_demo worker <pid> <nprocs>
<address>``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from stofnet_tpu_torch.models.stofnet import StofNet
from stofnet_tpu_torch.parallel import mesh as dp_mesh
from stofnet_tpu_torch.train.steps import (
    LossConfig, make_optimizer, make_train_step,
)

NPROC = 2
STEPS = 4
BATCH_PER_PROC = 4  # global batch = NPROC * BATCH_PER_PROC
LENGTH = 800
SEED = 7
TIMEOUT_S = 420
REPO = Path(__file__).resolve().parents[2]


def _global_batch(step: int):
    """Deterministic (global batch, 1, L) frame and GT, the same on every
    process (each takes its own rows)."""
    rng = np.random.default_rng(SEED + step)
    b = NPROC * BATCH_PER_PROC
    frame = rng.standard_normal((b, 1, LENGTH)).astype(np.float32)
    gt = rng.uniform(10, LENGTH - 10, size=(b, 1)).astype(np.float32)
    gt_true = np.round(gt[:, None, :] * 4).astype(np.int32)
    return frame, gt, gt_true


def _train_losses(mesh=None) -> List[float]:
    """STEPS losses of the amp train step on the global batches: this
    rank's rows under ``mesh``, all of them without."""
    model = StofNet(num_features=16, semi_global_scale=8, num_blocks=4,
                    generator=torch.Generator().manual_seed(0),
                    device="cpu")
    if mesh is not None:
        dp_mesh.replicate(mesh, model)
    optimizer, scheduler = make_optimizer(model.parameters(),
                                          steps_per_epoch=1)
    step = make_train_step(model, optimizer, scheduler,
                           LossConfig(upsample_factor=4, max_echoes=8),
                           amp=True, mesh=mesh)
    losses = []
    for i in range(STEPS):
        batch = [torch.from_numpy(a) for a in _global_batch(i)]
        if mesh is not None:
            batch = dp_mesh.shard_batch(mesh, batch)
        losses.append(float(step(*batch)["loss"]))
    return losses


def worker(pid: int, nproc: int, address: str) -> None:
    torch.set_num_threads(max(1, torch.get_num_threads() // nproc))
    dp_mesh.init_distributed(address, nproc, pid, device="cpu")
    try:
        mesh = dp_mesh.make_mesh()
        losses = _train_losses(mesh)
        if not all(np.isfinite(losses)):
            raise RuntimeError(f"non-finite losses {losses}")
        # cross-process agreement asserted in the job
        every = dp_mesh.gather_rows(mesh, torch.tensor([losses]))
        if not bool((every == every[0]).all()):
            raise RuntimeError(f"cross-process loss divergence: {every}")
    finally:
        dp_mesh.leave()
    print("WORKER_OK", pid, json.dumps(losses), flush=True)


def main() -> Dict:
    t0 = time.time()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO), *filter(None, [env.get("PYTHONPATH")])])
    with tempfile.TemporaryDirectory(prefix="stofnet-demo-") as tmp:
        address = f"file://{tmp}/store"
        procs = [subprocess.Popen(
            [sys.executable, "-m", "stofnet_tpu_torch.scripts.multihost_demo",
             "worker", str(p), str(NPROC), address],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env) for p in range(NPROC)]
        try:
            outs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(10)
    losses = {}
    for p, out in zip(procs, outs):
        if p.returncode != 0 or "WORKER_OK" not in out:
            raise SystemExit(f"worker failed (rc={p.returncode}):\n"
                             + out[-2000:])
        line = next(ln for ln in out.splitlines()
                    if ln.startswith("WORKER_OK"))
        _, pid, blob = line.split(" ", 2)
        losses[int(pid)] = json.loads(blob)
    if losses[0] != losses[1]:
        raise SystemExit(f"launcher-level divergence: {losses}")
    single = _train_losses()
    dev = float(np.max(np.abs(np.asarray(single) - np.asarray(losses[0]))))
    if not dev < 5e-3:
        raise SystemExit(f"multi-process against single-process loss "
                         f"deviation {dev}: {losses[0]} vs {single}")
    out = dict(processes=NPROC, losses=losses[0], single=single,
               max_deviation=dev, seconds=time.time() - t0)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "worker":
        worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        main()
