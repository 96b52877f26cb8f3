"""Data- and sequence-parallel steps against the single-process step::

    python -m stofnet_tpu_torch.scripts.dp_check [--device cpu] [--dp 2]
        [--sp 1] [--length 640] [--batch 8] [--model stofnet ...]

:func:`run_cases` runs a list of cases, each a model, its weights and one
global batch: the train step (``train/steps.make_train_step``, f32 or
amp, ``remat``, ``accum``), the eval step, or a job array's step. Under a
live process group (a rank of ``parallel/mesh.launch``) each rank feeds
its shard of the batch through the mesh of the case's ``mesh`` shape
(dp, sp), by default every rank on dp: its rows, and at sp > 1 its
samples of them (by the family's sharding rule); alone, the whole
batch. Comparing the two
runs' results is the check: the loss, the parameters and gradients after
the first step, BatchNorm's running statistics, Kuleshov's dropout masks
and the eval step's outputs. A rank also reports whether its parameters
equal every other rank's bit for bit. The command line runs, on dp x sp
ranks, the StofNet f32 and amp steps and (at sp = 1) SincNet's, and
prints both runs' differences (``share_within``: the share of the
parameters within 1e-5) and the ms of 2 steps timed after the
compared one (rank 0's, host clock). ``--model`` names the registry
families to run instead (StofNet's f32 and amp steps, another family's
f32 step, GradPeak's eval step; :func:`zoo_case`, Kuleshov's input the
whole row).
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
from stofnet_tpu_torch.parallel import seq
from stofnet_tpu_torch.train.steps import (
    LossConfig, make_eval_step, make_optimizer, make_train_step,
)


def _numpy(tree) -> Dict[str, np.ndarray]:
    """Copies: a CPU tensor's ``numpy()`` shares its memory, which a later
    step would update."""
    return {k: v.detach().float().cpu().numpy().copy()
            for k, v in tree.items()}


def run_case(case: Dict[str, Any], device, mesh=None) -> Dict[str, Any]:
    """One case on ``device``: the whole batch, or this rank's shard under
    ``mesh``. Keys of ``case``: ``model`` (a registry name), ``arch``
    (``build_model``'s keywords), ``state`` (name -> array; else drawn
    from ``seed``), ``frame`` (B, 1, L), ``gt_sample`` (B, G), ``loss``
    (``LossConfig``'s keywords), and optionally ``amp``, ``remat``,
    ``accum``, ``seed``, ``steps`` (compared, 1), ``timed`` (steps timed
    after those, 0), ``eval`` (the eval step instead), ``mesh`` (the
    (dp, sp) shape of the ranks' mesh, read by :func:`run_cases`),
    ``masks`` (record Kuleshov's dropout masks), and controls that must
    miss: ``per_rank_stats`` (BatchNorm on each rank's own statistics, as
    plain DDP), ``halo_stats`` (under sp, BatchNorm's statistics over the
    whole window, halo included) and ``contiguous_rows`` (under
    ``accum``, each rank its contiguous block of the batch, so its i-th
    micro-batch is not JAX's)."""
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
    if mesh is not None:  # frames over dp and sp, GT over dp
        accum = 1 if case.get("eval") else int(case.get("accum", 1))
        if case.get("contiguous_rows"):  # a control that must miss
            accum = 1
        batch = [dp_mesh.shard_batch(mesh, batch[0], 2, accum),
                 *dp_mesh.shard_batch(mesh, batch[1:], accum=accum)]
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
    record = contextlib.ExitStack()
    if case.get("halo_stats"):
        record.enter_context(mock.patch.object(
            seq.Shard, "own_slice", lambda self, n: (0, n)))
    if case.get("masks"):
        draw = kuleshov_module.keep_mask

        def keep(*a, **kw):
            m = draw(*a, **kw)
            masks.append(m.cpu().numpy())
            return m

        model.keep_mask = keep
        record.enter_context(mock.patch.object(kuleshov_module, "keep_mask",
                                               keep))
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
    the mesh of its ranks of the case's ``mesh`` shape (this rank's
    results), else alone. With ``probe_gloo``, ranks of a gloo group on
    the card append :func:`gloo_takes_cuda`'s finding."""
    live = dp_mesh.live()
    out = []
    for c in cases:
        mesh = dp_mesh.make_mesh(*c.get("mesh", (None,))) if live else None
        out.append(run_case(c, device if mesh is None else mesh.device,
                            mesh))
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


# each family's build arguments and loss keywords for zoo_case: heatmap
# families at their registry upsample factor, Zonzini and GradPeak on the
# regression loss, Kuleshov's input the whole row (sample_num * 4)
ZOO_ARCH = {
    "stofnet": ({}, dict(upsample_factor=4)),
    "espcn": ({}, dict(upsample_factor=4)),
    "edsr": ({}, dict(upsample_factor=4)),
    "sincnet": (dict(fs=1e6, rf_scale_factor=1), dict(upsample_factor=1)),
    "unet": (dict(n_layers=2), dict(upsample_factor=1)),
    "zonzini": ({}, dict(upsample_factor=4, model_kind="regression")),
    "kuleshov": (dict(rf_scale_factor=4), dict(upsample_factor=4)),
    "gradpeak": (dict(rf_scale_factor=4),
                 dict(upsample_factor=4, model_kind="regression")),
}


def zoo_case(model: str, length: int, batch: int, seed: int = 0,
             **kw) -> Dict[str, Any]:
    """A case of registry family ``name`` at ``length`` on seeded noise
    with one echo a row (the weights drawn from ``seed``); GradPeak's is
    an eval case (it has no parameters)."""
    rng = np.random.default_rng(seed)
    arch, loss = ZOO_ARCH[model]
    arch = dict(arch)
    if model == "kuleshov":
        arch["sample_num"] = length // arch["rf_scale_factor"]
    case = dict(model=model, arch=arch, seed=seed,
                frame=rng.standard_normal((batch, 1, length)).astype(
                    np.float32),
                gt_sample=rng.uniform(5, length - 5, (batch, 1)).astype(
                    np.float32),
                loss=dict(max_echoes=8, **loss), name=model)
    if model == "gradpeak":
        case["eval"] = True
    case.update(kw)
    return case


def largest(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray]) -> float:
    return max((float(np.max(np.abs(a[k] - b[k]))) for k in a), default=0.0)


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None)
    p.add_argument("--dp", type=int, default=2)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--length", type=int, default=640)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--model", nargs="+", default=None,
                   help="registry families (default: StofNet, and SincNet "
                        "at sp=1)")
    a = p.parse_args(argv)
    device = resolve_device(a.device)
    shape = dict(mesh=(a.dp, a.sp), timed=2)
    cases = []
    for name in a.model or ["stofnet"]:
        if name == "stofnet":
            cases += [stofnet_case(a.length, a.batch, **shape),
                      stofnet_case(a.length, a.batch, amp=True,
                                   name="stofnet amp", **shape)]
        else:
            cases.append(zoo_case(name, a.length, a.batch, **shape))
    if a.sp == 1 and a.model is None:
        cases.append(sincnet_case(a.length, a.batch, **shape))
    alone = run_cases(cases, device)
    n = a.dp * a.sp
    devices = ([dp_mesh.rank_device(device, r) for r in range(n)]
               if device.type == "cuda" else [device] * n)
    ranks = dp_mesh.launch(run_cases, (cases, device), devices=devices)
    for one, dp in zip(alone, ranks):
        if "params" not in one:  # an eval case (GradPeak)
            print(json.dumps(dict(
                model=one["name"], dp=a.dp, sp=a.sp,
                rows_equal=bool(np.array_equal(one["es_sample"],
                                               dp["es_sample"])),
                loss=float(one["loss"]), dp_loss=float(dp["loss"]))))
            continue
        print(json.dumps(dict(
            model=one["name"], dp=a.dp, sp=a.sp, loss=one["loss"],
            dp_loss=dp["loss"],
            params_max_diff=largest(one["params"], dp["params"]),
            share_within=float(np.mean(np.concatenate([
                np.ravel(np.abs(one["params"][k] - dp["params"][k]) < 1e-5)
                for k in one["params"]]))),
            ms_single=one["ms"], ms_ranks=dp["ms"],
            buffers_max_diff=largest(one["buffers"], dp["buffers"]),
            ranks_equal=dp["ranks_equal"])))


if __name__ == "__main__":
    main()
