"""Job-array driver: N runs as one program (replaces
``stofnet_tpu/cli/array.py``), on the card unless ``device=cpu``.

The reference runs one process a row of its SLURM job arrays
(``bash_scripts/chirp_benchmark.sh:14``, ``train_pala_array.sh:14``).
Here the members are vmapped over a member axis in one process
(``parallel/array.py``). The mode follows the keys given:

- ``seeds=N`` (train): N members of one model seeded ``seed``,
  ``seed + 1``, ... on the same data stream, one vmapped step a batch;
  a checkpoint per member (the single-model format, with its own AdamW
  state and step: ``cli/main.py`` resumes or evaluates it) and a
  per-member summary::

      python -m stofnet_tpu_torch.cli.array seeds=4 model=stofnet \\
          epochs=20 data_dir=datasets/stof_chirp101_dataset

  ``lrs=[...]`` sweeps the learning rate across members: alone, every
  member starts from one init (the sweep isolates the rate); with
  ``seeds=N`` and N rates, member i is the pair (seed + i, lrs[i]). The
  rate of member i is exact: its whole AdamW update is scaled.
- ``model_files=[a,b,...]`` (eval): N checkpoints of one architecture
  over the test split in one program, a metrics row each::

      python -m stofnet_tpu_torch.cli.array evaluate=True model=stofnet \\
          model_files='[run_seed3008,run_seed3009]' th=Null \\
          data_dir=datasets/stof_chirp101_dataset

- ``th_sweep=[...]`` (eval): one checkpoint decoded at T thresholds from
  one forward a batch (thresholds > 0; the per-row-max mode is
  ``cli.main th=Null``)::

      python -m stofnet_tpu_torch.cli.array evaluate=True model=stofnet \\
          model_file=run_seed3008 th_sweep='[0.01,0.05,0.1]' \\
          data_dir=datasets/stof_chirp101_dataset

Early stopping in train mode watches the mean member validation loss: the
members run in lockstep and finish together.

``mesh=True [mesh_dp=N]`` shards the members over the dp axis
(``parallel/array.shard_members``): ranks on ``torch.distributed`` as
``cli/main.py``'s (started here, or this process as one rank under
``torchrun``), each training or evaluating its N / dp members with the
vmapped step on the whole batch; rank 0 gathers the members' losses and
metrics in member order and writes the logs, and each rank writes its
own members' checkpoints. JAX's refusals stay: ``mesh_sp`` must be 1,
and dp must divide N. ``th_sweep=`` runs on one device, as JAX's.

Departures from the JAX driver: ``model_files=`` is searched in
``ckpt_dir=`` only, as ``cli/main.py``'s ``model_file=``.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from stofnet_tpu_torch.cli.main import (
    DEFAULT_CONFIG, _host_batches, _loader_workers, _loss_config, _nanmean,
    setup, unet_layers,
)
from stofnet_tpu_torch.data.loader import (
    DataLoader, DevicePut, pipeline_batches, split_dataset,
)
from stofnet_tpu_torch.parallel import (
    init_array_state, make_array_eval_step, make_array_train_step,
    make_threshold_sweep_step, member_optimizer_state, shard_members,
    stack_checkpoint_variables,
)
from stofnet_tpu_torch.parallel.mesh import (
    broadcast_object, config_mesh, gather_rows, live, run_ranks,
)
from stofnet_tpu_torch.train.checkpoint import (
    find_checkpoint, load_model_variables, save_checkpoint,
)
from stofnet_tpu_torch.train.early_stop import EarlyStopping
from stofnet_tpu_torch.train.steps import make_optimizer
from stofnet_tpu_torch.utils.config import Config, load_config, merge_cli
from stofnet_tpu_torch.utils.logging import MetricsLogger, make_run_name
from stofnet_tpu_torch.utils.profiling import StepTraceProfiler


def _members(cfg: Config):
    """(seeds, lrs, lr_scales, same_init) of the train mode's keys, with
    JAX's guards."""
    lrs = [float(x) for x in cfg.get("lrs") or []]
    if not lrs:
        n = int(cfg.seeds)
        return [int(cfg.seed) + i for i in range(n)], [], None, False
    if any(lr <= 0 for lr in lrs):
        raise ValueError(f"lrs must be positive, got {lrs}")
    if not cfg.get("seeds") and len(set(lrs)) != len(lrs):
        # same-init sweep: duplicate lrs would train bit-identical members
        # and collide on the lr-tagged checkpoint names
        raise ValueError(f"duplicate lrs in {lrs}: same-init members "
                         f"would be bit-identical copies (add seeds=N "
                         f"to vary the init instead)")
    n = len(lrs)
    if cfg.get("seeds") and int(cfg.seeds) != n:
        raise ValueError(f"seeds={cfg.seeds} but {n} lrs given; with "
                         f"both keys each member is one (seed, lr) pair")
    # lrs alone: one init for every member, so that the sweep isolates
    # the lr
    same_init = not cfg.get("seeds")
    seeds = ([int(cfg.seed)] * n if same_init
             else [int(cfg.seed) + i for i in range(n)])
    return seeds, lrs, [lr / float(cfg.lr) for lr in lrs], same_init


def _n_members(cfg: Config) -> Optional[int]:
    """The member count the mesh shards: the train mode's, or
    ``model_files=``'s; None for ``th_sweep=`` (one device)."""
    if cfg.get("seeds") or cfg.get("lrs"):
        return len(_members(cfg)[0])
    if cfg.get("th_sweep"):
        return None
    return len(cfg.get("model_files") or [])


def _member_check(cfg: Config, n: int) -> Callable[[int], None]:
    """JAX's refusals of member sharding: ``mesh_sp`` must be 1 (at once,
    a rule of the array that holds after ROADMAP A.6b too), and dp must
    divide the ``n`` members (the returned check)."""
    if int(cfg.get("mesh_sp") or 1) != 1:
        raise ValueError("array mode shards members over dp; mesh_sp "
                         "must be 1 (length sharding would need per-member "
                         "batch sharding too)")

    def check(dp: int) -> None:
        if n % dp:
            raise ValueError(f"{n} members not divisible by mesh dp={dp}")
    return check


def _mine(mesh, n: int) -> range:
    """The members of this rank: all of them without a mesh."""
    if mesh is None:
        return range(n)
    k = n // mesh.dp
    return range(mesh.rank * k, (mesh.rank + 1) * k)


def _gather(mesh, t: torch.Tensor) -> np.ndarray:
    """Every member's rows (member order) of a per-member tensor."""
    return (t if mesh is None else gather_rows(mesh, t)).cpu().numpy()


def train_array(cfg: Config, logger: MetricsLogger,
                mesh=None) -> Dict[str, Any]:
    seeds, lrs, lr_scales, same_init = _members(cfg)
    n = len(seeds)
    ctx = setup(cfg)
    ds, kind = ctx["dataset"], ctx["info"]["kind"]
    up = int(cfg.upsample_factor)

    nw = _loader_workers(cfg)
    train_idx, val_idx = split_dataset(len(ds), 0.2, seed=int(cfg.seed))
    train_loader = DataLoader(ds, train_idx, batch_size=int(cfg.batch_size),
                              shuffle=True, drop_last=True,
                              seed=int(cfg.seed), num_workers=nw)
    val_loader = DataLoader(ds, val_idx, batch_size=int(cfg.batch_size),
                            drop_last=True, num_workers=nw)
    if len(train_loader) == 0 or len(val_loader) == 0:
        raise ValueError("empty train or val split at this batch_size "
                         "(drop_last); lower batch_size or enlarge the "
                         "dataset")

    lcfg = _loss_config(cfg, ctx["model_kind"])
    state = init_array_state(ctx["build"], seeds,
                             allow_duplicate_seeds=same_init)
    mine = _mine(mesh, n)
    if mesh is not None:
        state = shard_members(mesh, state)
        if lr_scales:
            lr_scales = [lr_scales[i] for i in mine]
        if mesh.rank == 0:
            print(f"array train: {n} members over dp={mesh.shape['dp']}",
                  file=sys.stderr)
    optimizer, scheduler = make_optimizer(
        state.params.values(), lr=float(cfg.lr),
        weight_decay=float(cfg.weight_decay), epochs=int(cfg.epochs),
        steps_per_epoch=max(1, len(train_loader)))
    astep = make_array_train_step(
        state, optimizer, scheduler, lcfg,
        remat=bool(cfg.get("remat", False)), amp=bool(cfg.get("amp", False)),
        accum=int(cfg.get("accum", 1) or 1), lr_scales=lr_scales)
    aeval = make_array_eval_step(state.model, lcfg)

    early = EarlyStopping(patience=int(cfg.patience), delta=float(cfg.delta))
    put = DevicePut(ctx["device"])
    profiler = StepTraceProfiler(
        cfg.get("profile_dir") if logger.write else None,
        cfg.get("profile_steps") or 5)
    # unique member tags (the seed alone repeats in a same-init lr sweep)
    member_tags = [f"seed{s}" + (f"_lr{lrs[i]:g}" if lrs else "")
                   for i, s in enumerate(seeds)]

    val_losses = np.full(n, np.inf)
    vm = np.full((n, 1, 7), np.nan)
    epochs_run = 0
    for epoch in range(int(cfg.epochs)):
        train_loader.set_epoch(epoch)
        lr_epoch = float(optimizer.param_groups[0]["lr"])
        for _, dev in pipeline_batches(
                _host_batches(train_loader, up, kind), put):
            losses = _gather(mesh, astep(*dev)["loss"])
            profiler.step()  # no-op unless profile_dir= is set
            if not np.all(np.isfinite(losses)):
                bad = [member_tags[i]
                       for i in np.nonzero(~np.isfinite(losses))[0]]
                raise RuntimeError(
                    f"non-finite train loss in member(s) {bad} at "
                    f"epoch {epoch}; lower the lr or drop those members")
            logger.log({"event": "train", "epoch": epoch,
                        "train_loss_members": losses.tolist()})

        vlosses, vmetrics = [], []
        for _, dev in pipeline_batches(
                _host_batches(val_loader, up, kind), put):
            out = aeval(state.variables(), *dev)
            vlosses.append(_gather(mesh, out["loss"]))  # (N,)
            vmetrics.append(_gather(mesh, out["toa_metrics"]))  # (N, B, 7)
        val_losses = np.sum(vlosses, axis=0)
        vm = np.concatenate(vmetrics, axis=1)  # (N, B_total, 7)
        epochs_run = epoch + 1
        logger.log({"event": "epoch", "epoch": epoch,
                    "val_loss_members": val_losses.tolist(),
                    "val_jaccard_members":
                        [_nanmean(vm[i, :, 3]) for i in range(n)],
                    "lr": lr_epoch})
        if early(float(np.mean(val_losses))):
            print(f"Finished at epoch: {epoch} (mean member val loss)",
                  file=sys.stderr)
            break

    profiler.close()  # write an unfinished trace window (short runs)
    # a checkpoint per member: each member is a single model's state; each
    # rank writes its own members'
    ckpt_dir = Path(cfg.ckpt_dir).absolute()
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    members = []
    for i, seed in enumerate(seeds):
        name = (f"{logger.run_name}_{member_tags[i]}"
                f"_rf-scale{cfg.rf_scale_factor}_epoch_{epochs_run}")
        path = ckpt_dir / name
        if i in mine:
            j = i - mine.start  # its index on this rank
            save_checkpoint(
                path, state.member(j),
                member_optimizer_state(optimizer, j,
                                       lr_scales[j] if lr_scales else 1.0),
                scheduler, step=scheduler.last_epoch, epoch=epochs_run)
        members.append({"seed": seed,
                        **({"lr": lrs[i]} if lrs else {}),
                        "val_loss": float(val_losses[i]),
                        "val_jaccard": _nanmean(vm[i, :, 3]),
                        "val_rmse": _nanmean(vm[i, :, 0]),
                        "checkpoint": str(path)})
        logger.log({"event": "member", **members[-1]})

    best = int(np.argmin(val_losses))
    summary = {"mode": "train_array", "members": members,
               "best_seed": seeds[best],
               **({"best_lr": lrs[best]} if lrs else {}),
               "best_val_loss": float(val_losses[best]),
               "epochs": epochs_run}
    logger.set_summary(**{k: v for k, v in summary.items()
                          if k != "members"})
    return summary


def eval_array(cfg: Config, logger: MetricsLogger,
               mesh=None) -> Dict[str, Any]:
    """Multi-checkpoint (``model_files=[...]``) or multi-threshold
    (``th_sweep=[...]``) evaluation over the test split."""
    profiler = StepTraceProfiler(
        cfg.get("profile_dir") if logger.write else None,
        cfg.get("profile_steps") or 5)
    cfg.evaluate = True
    ctx = setup(cfg)
    ds, kind, device = ctx["dataset"], ctx["info"]["kind"], ctx["device"]
    up = int(cfg.upsample_factor)
    lcfg = _loss_config(cfg, ctx["model_kind"])

    th_sweep = cfg.get("th_sweep")
    model_files = cfg.get("model_files")
    loader = DataLoader(ds, list(range(len(ds))),
                        batch_size=int(cfg.batch_size), drop_last=True,
                        num_workers=_loader_workers(cfg))

    if th_sweep:
        if ctx["model_kind"] != "heatmap":
            raise ValueError(f"th_sweep decodes heatmaps; model "
                             f"{cfg.model!r} is a {ctx['model_kind']} model")
        ths = [float(t) for t in th_sweep]
        if any(t <= 0 for t in ths):
            raise ValueError(f"th_sweep thresholds must be > 0, got {ths} "
                             "(the falsy per-row-max mode is a structural "
                             "decode branch; run it via cli.main th=Null)")
        labels = [f"th={t:g}" for t in ths]
        sweep = make_threshold_sweep_step(ctx["model"], lcfg)
        variables = ctx["model"].state_dict()
        ths_t = torch.tensor(ths, dtype=torch.float32, device=device)

        def run(f, gs, gt):
            return sweep(variables, f, gs, gt, ths_t)
    elif model_files:
        labels = [str(m) for m in model_files]
        vlist = []
        for m in labels:
            path = find_checkpoint(cfg.ckpt_dir, m)
            if path is None:
                raise FileNotFoundError(
                    f"checkpoint prefix {m!r} not found in {cfg.ckpt_dir} "
                    f"(array eval has no random-init fallback: a silently "
                    f"fresh member would poison the whole table)")
            vlist.append(load_model_variables(cfg.model, path,
                                              unet_layers(kind)))
            print(f"loaded checkpoint {path}", file=sys.stderr)
        variables = stack_checkpoint_variables(vlist)
        if mesh is not None:
            variables = shard_members(mesh, variables)
        variables = {k: v.to(device) for k, v in variables.items()}
        aeval = make_array_eval_step(ctx["model"], lcfg)

        def run(f, gs, gt):
            return aeval(variables, f, gs, gt)
    else:
        raise ValueError("array eval needs model_files=[...] or "
                         "th_sweep=[...]")

    all_metrics: List[np.ndarray] = []
    losses: List[np.ndarray] = []
    for _, dev in pipeline_batches(_host_batches(loader, up, kind),
                                   DevicePut(device)):
        out = run(*dev)
        all_metrics.append(_gather(mesh, out["toa_metrics"]))  # (N, B, 7)
        profiler.step()  # no-op unless profile_dir= is set
        if "loss" in out:
            losses.append(_gather(mesh, out["loss"]))

    profiler.close()  # write an unfinished trace window (short splits)
    vm = np.concatenate(all_metrics, axis=1)  # (N, total, 7)
    rows = []
    for i, label in enumerate(labels):
        rows.append({
            "member": label,
            "total_distance_mean": _nanmean(vm[i, :, 0]),
            "total_distance_std": float(np.nanstd(vm[i, :, 0])),
            # toa_rmse's jaccard, precision and recall are percentages
            "total_jaccard": _nanmean(vm[i, :, 3]),
            "precision": _nanmean(vm[i, :, 1]),
            "recall": _nanmean(vm[i, :, 2]),
            **({"val_loss": float(np.sum([v[i] for v in losses]))}
               if losses else {}),
        })
        logger.log({"event": "member", **rows[-1]})

    md = ["| Member | RMSE [sample] | Jaccard [%] | Precision [%] "
          "| Recall [%] |",
          "|---|---|---|---|---|"]
    for r in rows:
        md.append(f"| {r['member']} | {r['total_distance_mean']:.2f} "
                  f"±{r['total_distance_std']:.2f} | "
                  f"{r['total_jaccard']:.1f} | {r['precision']:.2f} | "
                  f"{r['recall']:.2f} |")
    table = "\n".join(md)
    if logger.write:
        (Path(logger.run_dir) / f"{logger.run_name}_array_table.md"
         ).write_text(table + "\n")
        print(table)
    summary = {"mode": "th_sweep" if th_sweep else "eval_array",
               "rows": rows}
    logger.set_summary(mode=summary["mode"], members=len(rows))
    return summary


def run(cfg: Config) -> Dict[str, Any]:
    n = _n_members(cfg) if cfg.get("mesh") else None
    if cfg.get("mesh") and n is None:  # th_sweep=: one device, as JAX's
        cfg.update(mesh=False)
    if n is not None and not live():
        return run_ranks(run, cfg, _member_check(cfg, n))
    config = dict(cfg)
    mesh = None
    if n is not None:
        # members ride dp; each rank's model and data on its own device
        mesh = config_mesh(cfg, _member_check(cfg, n))
        cfg.update(mesh=False, device=str(mesh.device))
    run_name = make_run_name(int(cfg.seed) + int(time.time()) % 100000,
                             cfg.get("run_dir", "runs"))
    if mesh is not None:  # rank 0's name on every rank
        run_name = broadcast_object(mesh, run_name)
    logger = MetricsLogger(cfg.get("run_dir", "runs"), run_name,
                           config=config,
                           wandb_group=cfg.logging if cfg.logging else None,
                           write=mesh is None or mesh.rank == 0)
    try:
        if cfg.get("seeds") or cfg.get("lrs"):
            out = train_array(cfg, logger, mesh)
        else:
            out = eval_array(cfg, logger, mesh)
        out["run_name"] = run_name
        return out
    finally:
        logger.finish()


def main(argv: Optional[list] = None) -> None:
    cfg = merge_cli(load_config(DEFAULT_CONFIG), argv)
    out = run(cfg)
    print(f"array run complete: {out.get('mode')}", file=sys.stderr)


if __name__ == "__main__":
    main()
