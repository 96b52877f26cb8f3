"""Data-parallel steps against the single-process step::

    python -m stofnet_tpu_torch.scripts.dp_check [--device cpu] [--dp 2]
        [--length 640] [--batch 8]

:func:`run_cases` runs a list of cases, each a model, its weights and one
global batch: the train step (``train/steps.make_train_step``, f32 or
amp, ``remat``, ``accum``), the eval step, or a job array's step. Under a live process group
(a rank of ``parallel/mesh.launch``) each rank feeds its shard of the
batch through the mesh; alone, the whole batch. Comparing the two runs'
results is the check: the loss, the parameters and gradients after the
first step, BatchNorm's running statistics, Kuleshov's dropout masks and
the eval step's outputs. A rank also reports whether its parameters equal
every other rank's bit for bit. The command line runs StofNet and SincNet
cases and prints both runs' differences.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
from typing import Any, Dict, List, Optional, Sequence
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

from stofnet_tpu_torch import resolve_device
from stofnet_tpu_torch.models import kuleshov as kuleshov_module
from stofnet_tpu_torch.models.batchnorm import BatchNorm
from stofnet_tpu_torch.models.registry import build_model
from stofnet_tpu_torch.parallel import (
    init_array_state, make_array_train_step, shard_members,
)
from stofnet_tpu_torch.parallel import mesh as dp_mesh
from stofnet_tpu_torch.train.steps import (
    LossConfig, make_eval_step, make_optimizer, make_train_step,
)


def _numpy(tree) -> Dict[str, np.ndarray]:
    return {k: v.detach().float().cpu().numpy() for k, v in tree.items()}


def run_case(case: Dict[str, Any], device, mesh=None) -> Dict[str, Any]:
    """One case on ``device``: the whole batch, or this rank's shard under
    ``mesh``. Keys of ``case``: ``model`` (a registry name), ``arch``
    (``build_model``'s keywords), ``state`` (name -> array; else drawn
    from ``seed``), ``frame`` (B, 1, L), ``gt_sample`` (B, G), ``loss``
    (``LossConfig``'s keywords), and optionally ``amp``, ``remat``,
    ``accum``, ``seed``, ``steps`` (compared, 1), ``timed`` (steps timed
    after those, 0), ``eval`` (the eval step instead), ``masks`` (record
    Kuleshov's dropout masks) and ``per_rank_stats`` (BatchNorm on each
    rank's own statistics, as plain DDP: a control that must miss)."""
    device = torch.device(device)
    model, _ = build_model(case["model"], device=device,
                           generator=torch.Generator().manual_seed(
                               int(case.get("seed", 0))),
                           **case.get("arch", {}))
    if case.get("state") is not None:
        model.load_state_dict({k: torch.tensor(np.asarray(v))
                               for k, v in case["state"].items()})
    if mesh is not None:
        dp_mesh.replicate(mesh, model)
    cfg = LossConfig(**case["loss"])
    up = cfg.upsample_factor
    frame = np.asarray(case["frame"], np.float32)
    gt = np.asarray(case["gt_sample"], np.float32)
    gt_true = np.round(gt[:, None, :] * up).astype(np.int32)
    batch = [torch.from_numpy(a).to(device) for a in (frame, gt, gt_true)]
    if case.get("members"):
        return run_members(case, device, cfg, batch, mesh)
    if mesh is not None:
        batch = dp_mesh.shard_batch(mesh, batch)
    out: Dict[str, Any] = {"name": case.get("name", case["model"])}
    if case.get("eval"):
        res = make_eval_step(model, cfg, mesh)(*batch)
        out.update({k: v.float().cpu().numpy() for k, v in res.items()})
        return out

    optimizer, scheduler = make_optimizer(model.parameters(),
                                          steps_per_epoch=1)
    step = make_train_step(model, optimizer, scheduler, cfg,
                           remat=bool(case.get("remat")),
                           amp=bool(case.get("amp")),
                           accum=int(case.get("accum", 1)),
                           seed=int(case.get("seed", 0)), mesh=mesh)
    if case.get("per_rank_stats"):
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.mesh = None
    masks: List[np.ndarray] = []
    record = contextlib.nullcontext()
    if case.get("masks"):
        draw = kuleshov_module.keep_mask

        def keep(*a, **kw):
            m = draw(*a, **kw)
            masks.append(m.cpu().numpy())
            return m

        model.keep_mask = keep
        record = mock.patch.object(kuleshov_module, "keep_mask", keep)
    losses = []
    with record:
        for i in range(int(case.get("steps", 1))):
            losses.append(float(step(*batch)["loss"]))
            if i == 0:
                out["grads"] = {k: p.grad.cpu().numpy()
                                for k, p in model.named_parameters()
                                if p.grad is not None}
    out.update(loss=losses, params=_numpy(dict(model.named_parameters())),
               buffers=_numpy(dict(model.named_buffers())), masks=masks)
    ms = []
    for _ in range(int(case.get("timed", 0))):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        step(*batch)["loss"].item()
        ms.append((time.perf_counter() - t0) * 1e3)
    out["ms"] = ms
    if mesh is not None:
        flat = torch.cat([p.detach().reshape(-1)
                          for p in model.parameters()])
        parts = dp_mesh.gather_rows(mesh, flat[None])
        out["ranks_equal"] = bool((parts == parts[0]).all())
    return out


def run_members(case: Dict[str, Any], device: torch.device,
                cfg: LossConfig, batch, mesh=None) -> Dict[str, Any]:
    """``case["members"]`` members (seeds ``seed``, ``seed + 1``, ...) one
    array step on the whole batch (``parallel/array``); under ``mesh``
    this rank's members (``shard_members``), the losses and parameters
    gathered in member order."""
    seed = int(case.get("seed", 0))

    def build(generator):
        return build_model(case["model"], device=device,
                           generator=generator, **case.get("arch", {}))[0]

    state = init_array_state(build, [seed + i
                                     for i in range(int(case["members"]))])
    if mesh is not None:
        state = shard_members(mesh, state)
    optimizer, scheduler = make_optimizer(state.params.values(),
                                          steps_per_epoch=1)
    loss = make_array_train_step(state, optimizer, scheduler, cfg)(
        *batch)["loss"]
    params = {k: v.detach() for k, v in state.params.items()}
    if mesh is not None:
        loss = dp_mesh.gather_rows(mesh, loss)
        params = {k: dp_mesh.gather_rows(mesh, v) for k, v in params.items()}
    return {"name": case.get("name", case["model"]),
            "loss": loss.cpu().numpy(), "params": _numpy(params)}


def run_cases(cases: Sequence[Dict[str, Any]], device,
              probe_gloo: bool = False) -> List[Dict]:
    """:func:`run_case` of each case: under a live process group through
    the mesh of its ranks (this rank's results), else alone. With
    ``probe_gloo``, ranks of a gloo group on the card append
    :func:`gloo_takes_cuda`'s finding."""
    mesh = dp_mesh.make_mesh() if dp_mesh.live() else None
    out = [run_case(c, device if mesh is None else mesh.device, mesh)
           for c in cases]
    if (probe_gloo and mesh is not None and mesh.backend == "gloo"
            and mesh.device.type == "cuda"):
        out.append({"gloo_cuda": gloo_takes_cuda()})
    return out


def gloo_takes_cuda() -> Dict[str, str]:
    """Under a live gloo group of ranks on the card: whether gloo itself
    takes a CUDA tensor for ``all_reduce`` and ``all_gather`` (what
    ``parallel/mesh.py``'s host staging for gloo stands in for); each
    rank tries the same calls in the same order."""
    x = torch.ones(4, device=torch.cuda.current_device())
    out = {}
    for name, call in (
            ("all_reduce", lambda: dist.all_reduce(x)),
            ("all_gather", lambda: dist.all_gather(
                [torch.empty_like(x) for _ in range(dist.get_world_size())],
                x))):
        try:
            call()
            torch.cuda.synchronize()
            out[name] = "taken"
        except RuntimeError as e:  # gloo's refusal of the device
            out[name] = f"refused: {str(e).splitlines()[0][:160]}"
    return out


def stofnet_case(length: int, batch: int, seed: int = 0,
                 **kw) -> Dict[str, Any]:
    """A StofNet train case at ``length`` on seeded noise with one echo a
    row (the weights drawn from ``seed``)."""
    rng = np.random.default_rng(seed)
    return dict(model="stofnet", arch={}, seed=seed,
                frame=rng.standard_normal((batch, 1, length)).astype(
                    np.float32),
                gt_sample=rng.uniform(5, length - 5, (batch, 1)).astype(
                    np.float32),
                loss=dict(upsample_factor=4, max_echoes=8), **kw)


def sincnet_case(length: int, batch: int, seed: int = 3,
                 **kw) -> Dict[str, Any]:
    """A SincNet (BatchNorm) train case at ``length``, fs 1 MHz."""
    rng = np.random.default_rng(seed)
    return dict(model="sincnet", arch=dict(fs=1e6, rf_scale_factor=1),
                seed=seed,
                frame=rng.standard_normal((batch, 1, length)).astype(
                    np.float32),
                gt_sample=rng.uniform(5, length - 5, (batch, 1)).astype(
                    np.float32),
                loss=dict(upsample_factor=1, max_echoes=8), **kw)


def largest(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray]) -> float:
    return max((float(np.max(np.abs(a[k] - b[k]))) for k in a), default=0.0)


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None)
    p.add_argument("--dp", type=int, default=2)
    p.add_argument("--length", type=int, default=640)
    p.add_argument("--batch", type=int, default=8)
    a = p.parse_args(argv)
    device = resolve_device(a.device)
    cases = [stofnet_case(a.length, a.batch),
             sincnet_case(a.length, a.batch)]
    alone = run_cases(cases, device)
    devices = ([dp_mesh.rank_device(device, r) for r in range(a.dp)]
               if device.type == "cuda" else [device] * a.dp)
    ranks = dp_mesh.launch(run_cases, (cases, device), devices=devices)
    for one, dp in zip(alone, ranks):
        print(json.dumps(dict(
            model=one["name"], loss=one["loss"], dp_loss=dp["loss"],
            params_max_diff=largest(one["params"], dp["params"]),
            buffers_max_diff=largest(one["buffers"], dp["buffers"]),
            ranks_equal=dp["ranks_equal"])))


if __name__ == "__main__":
    main()
