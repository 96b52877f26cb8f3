"""Train / evaluate driver (replaces ``stofnet_tpu/cli/main.py`` for the
registry's models on chirp, PALA and rat data)::

    python -m stofnet_tpu_torch.cli.main key=value ...

with the JAX driver's config (``cli/config.yaml``, the port's copy) and
semantics: ``evaluate=True`` runs the benchmark protocol over the test
split (``int8=True`` scores the int8-SGB forward), otherwise the training
recipe (80/20 split, AdamW with the per-epoch cosine, early stopping, a
non-finite check after every step, a rolling ``_last`` checkpoint each
epoch, ``resume=``, ``export_pth=``). The host loop feeds batches through
``data/loader.DevicePut`` (pinned staging, a side-stream copy) and logs
JSONL through ``utils/logging.MetricsLogger``.

Departures from the JAX driver:

- ``device=`` (new): the card (``cuda``) by default, as every entry point
  of the port; ``device=cpu`` runs on the CPU. Without a card and without
  ``device=cpu``, ``setup`` raises.
- ``mesh=True [mesh_dp=N]`` runs data-parallel ranks on
  ``torch.distributed`` (``parallel/mesh.py``), one process a device:
  started here (this process rank 0, the others spawned) when no process
  group is live, or this process as one rank under ``torchrun`` or
  ``parallel.init_distributed``. JAX's run is one program over the global
  batch; here each rank loads its rows of each global batch
  (``DataLoader(shard=)``) and the steps compute the global batch's loss
  normaliser, BatchNorm statistics, gradient mean, dropout masks and
  evaluation rows (``train/steps.py``). ``run`` returns rank 0's summary.
  Only rank 0 writes the run's files (JSONL, summary, checkpoints,
  ``export_pth``, figures, artifacts, traces); every rank reads
  ``model_file=`` and ``resume=``, and rank 0's weights are broadcast.
  ``mesh_dp`` defaults to the card count over ``mesh_sp`` (1 on the CPU,
  where any mesh runs: the ranks share the CPU); dp * sp may not exceed
  the cards.
- ``mesh=True mesh_sp=N`` also shards the sample axis of the frames of
  every registry model, on chirp, PALA and rat data (PALA's and rat's
  channel-flattened rows, ``batch_to_arrays``), by the family's rule
  (``parallel/seq.py``): the ranks of one dp row (its sp group) load the
  same rows, each keeps its L / sp samples of them, and the steps run
  each shard's forward (a window widened by its neighbours' halo, or
  Kuleshov's layer-wise halos), train on the shard's own positions (or,
  for Zonzini, on the sp group's joined pool) and join an sp group's
  outputs before the decode. JAX's refusals stay (``batch_size % dp``,
  ``L % sp``). ``int8=True`` under sp calibrates on the global batches'
  whole rows, as at sp = 1, and runs the int8 forward on each rank's
  window with the activation scales joined over the sp group.
- ``accum=N`` on a mesh: each rank loads its slice of each of JAX's
  micro-batches (``utils/collectives.accum_rows``), so ``batch_size`` must
  divide by ``mesh_dp * accum``.
- ``compile_cache=`` is accepted and does nothing (eager PyTorch compiles
  nothing to cache); a line on stderr says so.
- A fresh model is drawn from ``torch.Generator().manual_seed(seed)``
  (``models/registry.build_model``): flax's init distribution, not its
  bits. ``model_file=`` is searched in ``ckpt_dir=`` only. Kuleshov's
  dropout draws from a generator seeded by the seed and the step
  (``train/steps.dropout_seed``), where JAX folds the step into its key.
- A checkpoint is one ``torch.save`` file (``train/checkpoint.py``), not
  an orbax directory; ``resume=`` names that file.
"""

from __future__ import annotations

import os
import random as pyrandom
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from stofnet_tpu_torch import resolve_device
from stofnet_tpu_torch.data.loader import (
    DataLoader, DevicePut, default_num_workers, pipeline_batches,
    split_dataset,
)
from stofnet_tpu_torch.models.registry import (
    REGRESSION, build_model, export_checkpoint,
)
from stofnet_tpu_torch.ops.conv import full_f32
from stofnet_tpu_torch.ops.peaks import coords2mask
from stofnet_tpu_torch.parallel.mesh import (
    Sharding, broadcast_object, config_mesh, gather_rows, live, replicate,
    run_ranks,
)
from stofnet_tpu_torch.parallel.seq import SeqPlan
from stofnet_tpu_torch.train.checkpoint import (
    find_checkpoint, load_checkpoint, load_model_variables, save_checkpoint,
)
from stofnet_tpu_torch.train.early_stop import EarlyStopping
from stofnet_tpu_torch.train.steps import (
    LossConfig, make_eval_step, make_optimizer, make_train_step,
    resume_optimizer,
)
from stofnet_tpu_torch.train.threshold import find_threshold
from stofnet_tpu_torch.utils.config import Config, load_config, merge_cli
from stofnet_tpu_torch.utils.logging import MetricsLogger, make_run_name
from stofnet_tpu_torch.utils.profiling import StepTraceProfiler, count_params

DEFAULT_CONFIG = Path(__file__).parent / "config.yaml"

def unet_layers(kind: str) -> int:
    """The unet's depth (JAX's n_layers): 2 on chirp data, 10 on PALA or
    rat data."""
    return 2 if kind == "chirp" else 10


def _nanmean(x) -> float:
    x = np.asarray(x, dtype=np.float64)
    ok = ~np.isnan(x)
    return float(x[ok].mean()) if ok.any() else float("nan")


def _save_channel_overview(path: Path, frame: np.ndarray, gt: np.ndarray,
                           es: np.ndarray, logger: MetricsLogger) -> None:
    """Channel-overview panel, saved locally, mirrored to W&B when enabled;
    nothing where matplotlib is missing."""
    try:
        import matplotlib.pyplot as plt

        from stofnet_tpu_torch.utils.plotting import plot_channel_overview
    except ImportError:
        return
    fig = plot_channel_overview(frame[:, 0], gt, echoes=es)
    logger.log_figure("channel_overview", fig, path=path)
    plt.close(fig)


def _save_comparison(path: Path, frame: np.ndarray, es: np.ndarray,
                     gt: np.ndarray, label: str,
                     logger: MetricsLogger) -> None:
    """Per-eval-sample comparison figure; nothing where matplotlib is
    missing."""
    try:
        import matplotlib.pyplot as plt

        from stofnet_tpu_torch.utils.plotting import plot_comparison
    except ImportError:
        return
    fig = plot_comparison(frame[0, 0], [np.asarray(es[0])], [label],
                          gt_samples=gt[0])
    logger.log_figure("comparison", fig, path=path)
    plt.close(fig)


def dataset_kind(data_dir: str) -> str:
    d = str(data_dir).lower()
    if "pala" in d:
        return "pala"
    if "rat" in d:
        return "rat"
    if "chirp" in d:
        return "chirp"
    raise ValueError(f"no dataset class for data path {data_dir!r}")


def build_dataset(cfg: Config):
    """Instantiate the dataset + transforms; returns (dataset, info dict).
    Chirp data crops and adds noise when training; PALA and rat data add
    noise only (rat data through the temporal filter), as in JAX."""
    from stofnet_tpu_torch.data.transforms import (
        AddNoise, Compose, CropChannelData, NormalizeVol,
    )

    kind = dataset_kind(cfg.data_dir)
    rng = np.random.default_rng(cfg.seed)
    tf = [NormalizeVol()]
    if str(cfg.data_dir).lower().endswith(".zip"):
        from stofnet_tpu_torch.utils.zip_extract import zip_extract

        cfg.data_dir = str(zip_extract(cfg.data_dir))
    if kind == "chirp":
        from stofnet_tpu_torch.data.chirp import ChirpDataset

        if not cfg.evaluate:
            tf += [CropChannelData(ratio=cfg.crop_ratio, rng=rng),
                   AddNoise(snr=cfg.snr_db, rng=rng)]
        ds = ChirpDataset(
            root_dir=cfg.data_dir,
            split_dirname="test" if cfg.evaluate else "train",
            rf_scale_factor=cfg.rf_scale_factor,
            transforms=Compose(tf),
            seed=int(cfg.seed),
        )
        info = {"kind": kind, "fs": float(ds.cfg["fhz_sample"]),
                "c": float(ds.cfg["speed_of_sound"]),
                "channel_num": ds.get_channel_num(),
                "sample_num": ds.get_sample_num()}
    else:
        from stofnet_tpu_torch.data.pala import PalaDatasetRf

        if not cfg.evaluate:
            tf += [AddNoise(snr=cfg.snr_db, rng=rng)]
        ds = PalaDatasetRf(
            dataset_path=cfg.data_dir,
            sequences=cfg.sequences,
            rescale_factor=cfg.rf_scale_factor,
            ch_gap=cfg.ch_gap,
            angle_threshold=cfg.angle_threshold,
            clutter_db=cfg.clutter_db,
            temporal_filter_opt=(kind == "rat"),
            pow_law_opt=cfg.pow_law_opt,
            transforms=Compose(tf),
            seed=int(cfg.seed),
        )
        info = {"kind": kind, "fs": float(ds.get_key("fs")),
                "c": float(ds.get_key("c")),
                "wavelength": float(ds.get_key("wavelength")),
                "channel_num": ds.get_channel_num(),
                "sample_num": ds.get_sample_num()}
    return ds, info


def batch_to_arrays(batch, kind: str = "chirp"
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(frame (B', 1, L), gt_sample (B', G)) of a dataset batch, invalid GT
    (NaN or <= 0) as 0. A PALA or rat batch gives wave index
    ``min(1, n_waves - 1)`` with its channels flattened into the batch:
    B' = B * C, G = MAX_TARGETS."""
    if kind == "chirp":
        _, rf, _, gt_sample, _, _ = batch
        frame = rf[:, None, :].astype(np.float32)
        gt = gt_sample.reshape(-1, 1).astype(np.float32)
    else:
        frame_all, gt_all = batch[0], batch[2]
        wv_idx = min(1, frame_all.shape[1] - 1)
        fr = frame_all[:, wv_idx]  # (B, C, L)
        frame = fr.reshape(-1, fr.shape[-1])[:, None, :].astype(np.float32)
        g = gt_all[:, wv_idx]  # (B, C, E)
        gt = g.reshape(-1, g.shape[-1]).astype(np.float32)
    gt = np.where(np.isnan(gt) | (gt <= 0), 0.0, gt)
    return frame, gt


def _host_batches(loader, up: int, kind: str = "chirp"):
    for batch in loader:
        frame, gt = batch_to_arrays(batch, kind)
        gt_true = np.round(gt[:, None, :] * up).astype(np.int32)
        yield frame, gt, gt_true


def _loss_config(cfg: Config, model_kind: str = "heatmap") -> LossConfig:
    return LossConfig(
        kernel_size=int(cfg.kernel_size), sigma=float(cfg.sigma),
        mask_amplitude=float(cfg.mask_amplitude),
        lambda_value=float(cfg.lambda_value),
        nms_win_size=int(cfg.nms_win_size),
        th=None if cfg.th in (None, "Null") else float(cfg.th),
        etol=float(cfg.etol), upsample_factor=int(cfg.upsample_factor),
        max_echoes=int(cfg.get("max_echoes", 64)), model_kind=model_kind,
    )


def _batch_check(cfg: Config) -> Callable[[int], None]:
    """JAX's ``_shard_inputs`` refusal: a batch that dp does not divide."""
    def check(dp: int) -> None:
        if int(cfg.batch_size) % dp:
            raise ValueError(f"batch_size={cfg.batch_size} not divisible by "
                             f"mesh_dp={dp}")
    return check


def setup(cfg: Config) -> Dict[str, Any]:
    """Common setup: seeds, dataset, model (fresh or from ``model_file=``)
    on the device. Returns a dict; its ``build(generator)`` draws another
    fresh model of the configuration. Under ``mesh=True`` (a live process
    group) the device is this rank's and ``mesh`` its mesh; the model
    holds rank 0's weights."""
    mesh = (config_mesh(cfg, _batch_check(cfg)) if cfg.get("mesh")
            else None)
    device = (mesh.device if mesh is not None
              else resolve_device(cfg.get("device")))
    pyrandom.seed(cfg.seed)
    np.random.seed(cfg.seed)

    # the model's config changes that the dataset depends on, before it is
    # built: the unet's rf-scale fold (reference main.py:44-46) and
    # gradpeak's forced evaluate (main.py:165, which the reference applies
    # after the build); the registry's updates then repeat them
    name = str(cfg.model).lower()
    if name == "unet":
        cfg.rf_scale_factor = int(cfg.rf_scale_factor) * int(
            cfg.upsample_factor)
        cfg.upsample_factor = 1
    elif name == "gradpeak":
        cfg.evaluate = True

    ds, info = build_dataset(cfg)
    # a checkpoint found skips the fresh draw (Kuleshov's is 1.2e9
    # weights): the model is built without data and takes its tensors
    path = None
    if cfg.model_file and name != "gradpeak":  # gradpeak: no parameters
        path = find_checkpoint(cfg.ckpt_dir, cfg.model_file)
        if path is None:
            # the reference runs the fresh init on a prefix it does not
            # find; keep that, and say so loudly
            print(f"WARNING: checkpoint prefix {cfg.model_file!r} not "
                  f"found in {cfg.ckpt_dir}: continuing with RANDOM INIT; "
                  f"metrics will not reflect trained weights",
                  file=sys.stderr)
    dtype = torch.bfloat16 if cfg.get("compute_dtype") == "bfloat16" else None
    arch = dict(
        dataset_kind=info["kind"], upsample_factor=int(cfg.upsample_factor),
        sample_num=info["sample_num"],
        rf_scale_factor=int(cfg.rf_scale_factor), fs=info["fs"],
        th=None if cfg.th in (None, "Null") else float(cfg.th), dtype=dtype,
        semi_global_scale=int(cfg.get("semi_global_scale", 80)),
        n_layers=unet_layers(info["kind"]))

    def build(generator: torch.Generator) -> torch.nn.Module:
        """A fresh model of this configuration (a job array's member)."""
        return build_model(name, generator=generator, device=device,
                           **arch)[0]

    model, updates = build_model(
        name, generator=torch.Generator().manual_seed(int(cfg.seed)),
        device="meta" if path is not None else device, **arch)
    cfg.update(updates)  # what the dataset reads was folded in above
    if path is not None:
        state = load_model_variables(name, path, unet_layers(info["kind"]))
        model.load_state_dict({k: v.to(device) for k, v in state.items()},
                              strict=True, assign=True)
        print(f"loaded checkpoint {path}", file=sys.stderr)
    if mesh is not None:
        replicate(mesh, model)
    return {"dataset": ds, "info": info, "model": model, "device": device,
            "cfg": cfg, "build": build, "mesh": mesh,
            "random_init": path is None and name != "gradpeak",
            "model_kind": "regression" if name in REGRESSION else "heatmap"}


def _loader_workers(cfg: Config) -> int:
    nw = cfg.get("num_workers")
    return default_num_workers() if nw is None else int(nw)


def _int8_eval_step(ctx: Dict[str, Any], loader, finish):
    """The eval step with the int8-SGB forward (``models/int8.py``),
    calibrated on up to 8 batches; decode, loss and metrics unchanged.
    On a mesh the calibration batches are the global ones: the ranks of
    an sp group load the same whole rows, gathered over dp. Under sp the
    forward runs on this rank's window (``parallel/seq.SeqPlan``), its
    activation scales the row's, joined over the sp group, and the
    heatmap's shards are gathered before the decode."""
    from stofnet_tpu_torch.models.int8 import (
        quantize_stofnet, stofnet_apply_int8,
    )

    cfg, model = ctx["cfg"], ctx["model"]
    if str(cfg.model).lower() != "stofnet":
        raise ValueError("int8=True supports model=stofnet only (the "
                         "quantized path is the SemiGlobalBlock; other "
                         "models have none)")
    # per-channel absmax over up to 8 batches: one quiet first batch must
    # not set a scale the rest of the split saturates
    calib = []
    for batch in loader:
        calib.append(batch_to_arrays(batch, ctx["info"]["kind"])[0])
        if len(calib) >= 8:
            break
    if not calib:
        raise ValueError("int8=True needs at least one eval batch for the "
                         "pre-pool requantization calibration")
    if ctx["mesh"] is not None:  # the global batches' calibration
        calib = [gather_rows(ctx["mesh"].over_dp(),
                             torch.from_numpy(c)).numpy() for c in calib]
    ov = {"upsample_factor": int(model.upsample_factor),
          "num_blocks": int(model.num_blocks),
          "semi_global_scale": int(model.semi_global_scale)}
    q = quantize_stofnet(model.state_dict(), torch.from_numpy(
        np.concatenate(calib)).to(ctx["device"]), **ov)
    dtype = (torch.bfloat16 if cfg.get("compute_dtype") == "bfloat16"
             else None)

    mesh = ctx["mesh"]
    plan = (None if mesh is None or mesh.sp == 1
            else SeqPlan(model, mesh, int8=True))

    def int8(x, shard=None):
        return stofnet_apply_int8(q, x, dtype=dtype, shard=shard, **ov)

    @torch.no_grad()
    def forward(frame):
        with full_f32():
            if plan is None:
                pred = int8(frame)
            else:
                x, shard = plan.shard(frame)
                pred = plan.join(plan.forward(int8, x, shard))
        return pred, pred.float().sum()

    def step(frame, gt_sample, gt_true):
        return finish(forward(frame)[0], gt_sample, gt_true)

    step.forward, step.finish = forward, finish
    print(f"int8 serving path: s8 SGB contract conv + s8 pre-pool tensor, "
          f"calibrated on {sum(c.shape[0] for c in calib)} waveforms "
          f"(weights/decode unchanged)", file=sys.stderr)
    return step


def evaluate(ctx: Dict[str, Any], logger: MetricsLogger) -> Dict[str, float]:
    """Benchmark protocol: whole test split, metrics per frame."""
    cfg, mesh = ctx["cfg"], ctx["mesh"]
    writer = _writer(mesh)
    profiler = StepTraceProfiler(cfg.get("profile_dir") if writer else None,
                                 cfg.get("profile_steps") or 5)
    ds = ctx["dataset"]
    kind = ctx["info"]["kind"]
    eval_step = make_eval_step(ctx["model"],
                               _loss_config(cfg, ctx["model_kind"]), mesh)
    loader = DataLoader(ds, batch_size=int(cfg.batch_size), drop_last=True,
                        num_workers=_loader_workers(cfg),
                        shard=_shard(mesh))
    _say_mesh("eval", mesh)
    up = int(cfg.upsample_factor)

    use_int8 = bool(cfg.get("int8"))
    if use_int8:
        eval_step = _int8_eval_step(ctx, loader, eval_step.finish)

    put = _put(ctx)
    total = {"loss": [], "distance": [], "jaccard": [], "time": []}
    val_step = 0
    # find_threshold runs on every eval batch like the reference;
    # th_search_interval > 1 thins the (host-side) search
    th_every = int(cfg.get("th_search_interval", 1))
    for batch_idx, (host, dev) in enumerate(
            pipeline_batches(_host_batches(loader, up, kind), put)):
        frame, gt, gt_true = host
        frame_d, gt_d, gt_true_d = dev

        # time the bare forward like the reference; the checksum's copy to
        # the host waits for the card
        tic = time.perf_counter()
        pred, checksum = eval_step.forward(frame_d)
        float(checksum)
        toc_fwd = time.perf_counter() - tic
        out = eval_step.finish(pred, gt_d, gt_true_d)
        metrics = out["toa_metrics"].cpu().numpy()
        toc = time.perf_counter() - tic
        profiler.step()  # no-op unless profile_dir= is set

        loss = float(out["loss"])
        val_step += 1
        # the first batch's time holds one-time work (cuDNN's algorithm
        # search): NaN, so the nan-mean summary is the steady state. The
        # denominator is cfg.batch_size, like the reference: the frames of
        # the batch, not PALA's channel-flattened frame.shape[0]
        bs = int(cfg.batch_size)
        infer_time = (toc_fwd / bs) if batch_idx > 0 else float("nan")
        step_time = (toc / bs) if batch_idx > 0 else float("nan")

        ideal_th = 0.0
        if ctx["model_kind"] == "heatmap" and batch_idx % th_every == 0:
            # the global batch's masks (gathered in batch order) against
            # its GT, on rank 0
            gt_all = (gt_true if mesh is None else
                      gather_rows(mesh.over_dp(),
                                  torch.from_numpy(gt_true)).numpy())
            if writer:
                pred_np = out["masks_pred"].float().cpu().numpy()
                masks_true = coords2mask(torch.from_numpy(gt_all),
                                         pred_np.shape[-1]).numpy()
                ideal_th = find_threshold(pred_np, masks_true)

        # per-frame data artifact + comparison figure every 100th batch
        # (rank 0's rows under a mesh)
        if (writer and batch_idx % 100 == 1
                and cfg.get("save_artifacts", True)):
            art_dir = Path(logger.run_dir) / f"{logger.run_name}_frames"
            art_dir.mkdir(parents=True, exist_ok=True)
            es = out["es_sample"].cpu().numpy()[:len(frame)]
            np.savez_compressed(
                art_dir / f"frame_{batch_idx:05d}.npz",
                data=frame, toa=es, gt=gt)
            _save_comparison(art_dir / f"frame_{batch_idx:05d}.png",
                             frame, es, gt, str(cfg.model), logger)

        for row in metrics:
            total["distance"].append(row[0])
            total["jaccard"].append(row[3])
            total["time"].append(infer_time)
        total["loss"].append(loss)

        logger.log({"event": "val", "val_step": val_step, "val_loss": loss,
                    "val_ideal_threshold": ideal_th,
                    "inference_time": infer_time,
                    "eval_step_time": step_time,
                    "val_toa_distance": _nanmean(metrics[:, 0]),
                    "val_toa_precision": _nanmean(metrics[:, 1]),
                    "val_toa_recall": _nanmean(metrics[:, 2]),
                    "val_toa_jaccard": _nanmean(metrics[:, 3])})

    profiler.close()  # write an unfinished trace window (short splits)
    if val_step == 0:
        raise ValueError(
            f"evaluation produced no batches: the eval split has "
            f"{len(ds)} item(s) and batch_size={cfg.batch_size} with "
            f"drop_last; lower batch_size or enlarge the split")

    dist = np.asarray(total["distance"], dtype=np.float64)
    summary = {
        "model_name": cfg.model,
        "total_jaccard": _nanmean(total["jaccard"]),
        "total_inference_time": _nanmean(total["time"]),
        "total_distance_mean": _nanmean(dist),
        "total_distance_std": float(np.std(dist[~np.isnan(dist)]))
        if (~np.isnan(dist)).any() else float("nan"),
        "val_loss": float(np.mean(total["loss"])) if total["loss"] else 0.0,
    }
    if use_int8:
        summary["int8"] = True
    logger.set_summary(**summary)
    return summary


def train(ctx: Dict[str, Any], logger: MetricsLogger) -> Dict[str, float]:
    cfg, mesh = ctx["cfg"], ctx["mesh"]
    writer = _writer(mesh)
    model = ctx["model"]
    profiler = StepTraceProfiler(cfg.get("profile_dir") if writer else None,
                                 cfg.get("profile_steps") or 5)
    ds = ctx["dataset"]
    up = int(cfg.upsample_factor)
    kind = ctx["info"]["kind"]

    nw = _loader_workers(cfg)
    train_idx, val_idx = split_dataset(len(ds), 0.2, seed=int(cfg.seed))
    train_loader = DataLoader(ds, train_idx, batch_size=int(cfg.batch_size),
                              shuffle=True, drop_last=True, seed=int(cfg.seed),
                              num_workers=nw, shard=_shard(mesh),
                              accum=int(cfg.get("accum", 1) or 1))
    val_loader = DataLoader(ds, val_idx, batch_size=int(cfg.batch_size),
                            drop_last=True, num_workers=nw,
                            shard=_shard(mesh))

    if int(cfg.epochs) > 0 and len(train_loader) == 0:
        raise ValueError(
            f"training would run zero steps: the train split has "
            f"{len(train_idx)} item(s) and batch_size={cfg.batch_size} "
            f"with drop_last; lower batch_size or enlarge the dataset")
    if int(cfg.epochs) > 0 and len(val_loader) == 0:
        raise ValueError(
            f"validation split is empty ({len(val_idx)} item(s) < "
            f"batch_size={cfg.batch_size} with drop_last): val_loss and "
            f"early stopping would run on zero batches")

    lcfg = _loss_config(cfg, ctx["model_kind"])
    optimizer, scheduler = make_optimizer(
        model.parameters(), lr=float(cfg.lr),
        weight_decay=float(cfg.weight_decay), epochs=int(cfg.epochs),
        steps_per_epoch=max(1, len(train_loader)))
    train_step = make_train_step(model, optimizer, scheduler, lcfg,
                                 remat=bool(cfg.get("remat", False)),
                                 amp=bool(cfg.get("amp", False)),
                                 accum=int(cfg.get("accum", 1) or 1),
                                 seed=int(cfg.seed), mesh=mesh)
    eval_step = make_eval_step(model, lcfg, mesh)

    start_epoch = 0
    if cfg.get("resume"):
        ckpt = load_checkpoint(cfg.resume, model.state_dict())
        resume_optimizer(optimizer, scheduler, ckpt["optimizer"],
                         ckpt["step"])
        start_epoch = int(ckpt["epoch"])
        print(f"resumed from {cfg.resume} at epoch {start_epoch}",
              file=sys.stderr)
    early = EarlyStopping(patience=int(cfg.patience), delta=float(cfg.delta))
    _say_mesh("train", mesh)

    # in-loop figure panels every N train batches, saved next to the JSONL
    plot_every = int(cfg.get("plot_interval", 800))
    plot_dir = Path(logger.run_dir) / f"{logger.run_name}_figs"
    put = _put(ctx)

    def lr_now() -> float:
        return float(optimizer.param_groups[0]["lr"])

    def save_ckpt(tag: str, epoch_count: int) -> Path:
        ckpt_dir = Path(cfg.ckpt_dir)
        ckpt_dir.mkdir(parents=True, exist_ok=True)
        return save_checkpoint(ckpt_dir / tag, model.state_dict(), optimizer,
                               scheduler, step=scheduler.last_epoch,
                               epoch=epoch_count)

    train_global = int(scheduler.last_epoch)
    epochs_run = start_epoch
    last = None  # the rolling checkpoint, while it holds the current state
    val_loss = float("inf")
    for epoch in range(start_epoch, int(cfg.epochs)):
        # epoch e's batch order is a function of (seed, e): resumed runs
        # replay the order the uninterrupted run would have used
        train_loader.set_epoch(epoch)
        lr_epoch = lr_now()  # the lr this epoch's steps use
        epoch_loss = 0.0
        for host, dev in pipeline_batches(
                _host_batches(train_loader, up, kind), put):
            frame, gt, gt_true = host
            frame_d, gt_d, gt_true_d = dev
            aux = train_step(frame_d, gt_d, gt_true_d)
            loss = float(aux["loss"])
            profiler.step()  # no-op unless profile_dir= is set
            if not np.isfinite(loss):
                # stop at the poisoned step with enough context to resume
                # from the last checkpoint
                raise RuntimeError(
                    f"non-finite train loss {loss} at step {train_global + 1}"
                    f" (epoch {epoch}, lr {lr_now():.2e});"
                    " resume from the last checkpoint with a lower lr")
            epoch_loss += loss  # sum of per-batch means
            train_global += 1
            logger.log({"event": "train", "train_step": train_global,
                        "train_loss": loss})
            if plot_every and train_global % plot_every == 0:
                out = eval_step(frame_d, gt_d, gt_true_d)
                _save_channel_overview(
                    plot_dir / f"train_{train_global:06d}.png", frame, gt,
                    out["es_sample"].cpu().numpy()[:len(frame)], logger)
        epochs_run = epoch + 1

        # validation: loss + tolerance-matched ToA metrics
        vlosses, vmetrics = [], []
        for _, dev in pipeline_batches(_host_batches(val_loader, up, kind),
                                       put):
            out = eval_step(*dev)
            vlosses.append(float(out["loss"]))
            vmetrics.append(out["toa_metrics"].cpu().numpy())
        val_loss = float(np.sum(vlosses))
        vm = (np.concatenate(vmetrics) if vmetrics
              else np.full((1, 7), np.nan))
        # the epoch's train_loss is the reference's sum(batch means) /
        # len(train split); per-batch means are in the 'train' events
        logger.log({"event": "epoch", "epoch": epoch,
                    "train_loss": epoch_loss / max(len(train_idx), 1),
                    "val_loss": val_loss,
                    "val_toa_distance": _nanmean(vm[:, 0]),
                    "val_toa_jaccard": _nanmean(vm[:, 3]),
                    "lr": lr_epoch})

        # a rolling 'last' checkpoint each epoch, so the non-finite
        # check's resume guidance has something to resume from
        if writer:
            last = save_ckpt(f"{logger.run_name}_last", epochs_run)

        if early(val_loss):
            print(f"Finished at epoch: {epoch}", file=sys.stderr)
            break

    profiler.close()  # write an unfinished trace window (short runs)
    name = (f"{logger.run_name}_rf-scale{cfg.rf_scale_factor}"
            f"_epoch_{epochs_run}")
    path = Path(cfg.ckpt_dir).absolute() / name
    if writer:
        try:
            # nothing moved since the rolling checkpoint: its file under
            # the final name, not a second write (Kuleshov's state is 15 GB)
            if last is None:
                raise FileNotFoundError("no epoch ran")
            os.link(last, path)
        except OSError:  # also where the file system has no hard links
            path = save_ckpt(name, epochs_run)
        logger.log_artifact(path, name)  # W&B mirror
    summary = {"val_loss": val_loss, "checkpoint": str(path),
               "epochs": epochs_run}
    if (writer and cfg.get("export_pth")
            and str(cfg.model).lower() != "gradpeak"):
        # a reference-compatible .pth beside the checkpoint
        summary["export_pth"] = export_checkpoint(
            cfg.model, model.state_dict(), Path(cfg.ckpt_dir) / f"{name}.pth")
    logger.set_summary(final_val_loss=val_loss, **summary)
    return summary


def _writer(mesh) -> bool:
    """Whether this process writes the run's files: rank 0 of a mesh."""
    return mesh is None or mesh.rank == 0


def _shard(mesh) -> Tuple[int, int]:
    """A loader's ``shard=``: this rank's rows of each global batch, by
    its dp coordinate (the ranks of one sp group load the same rows)."""
    return (0, 1) if mesh is None else (mesh.dp_index, mesh.dp)


def _put(ctx: Dict[str, Any]) -> Callable:
    """The device copy of a host batch (frame, gt, gt_true): under sp > 1
    the frame's copy is this rank's L / sp samples (JAX's
    ``batch_seq_sharding`` of the frame; the loader took the rows)."""
    put, mesh = DevicePut(ctx["device"]), ctx["mesh"]
    if mesh is None or mesh.sp == 1:
        return put
    samples = Sharding(mesh, (None, None, "sp"))
    return lambda batch: put((samples.take(batch[0]), *batch[1:]))


def _say_mesh(what: str, mesh) -> None:
    if mesh is not None and mesh.rank == 0:
        print(f"{what} on mesh dp={mesh.shape['dp']} sp={mesh.shape['sp']}",
              file=sys.stderr)


def run(cfg: Config) -> Dict[str, Any]:
    if cfg.get("int8") and not cfg.evaluate:
        raise ValueError("int8=True is a SERVING path (evaluate=True only):"
                         " training runs full-precision — drop the flag or"
                         " add evaluate=True")
    if cfg.get("mesh") and not live():
        return run_ranks(run, cfg, _batch_check(cfg))
    if cfg.get("compile_cache"):
        print(f"compile_cache={cfg.compile_cache}: ignored, the port runs "
              f"eager PyTorch and compiles nothing to cache", file=sys.stderr)
    ctx = setup(cfg)
    mesh = ctx["mesh"]
    # trainable parameters only, like the reference's torchinfo count
    n_params = count_params(dict(ctx["model"].named_parameters()))
    run_name = make_run_name(int(cfg.seed) + int(time.time()) % 100000,
                             cfg.get("run_dir", "runs"))
    if mesh is not None:  # rank 0's name on every rank
        run_name = broadcast_object(mesh, run_name)
    logger = MetricsLogger(cfg.get("run_dir", "runs"), run_name,
                           config=dict(cfg),
                           wandb_group=cfg.logging if cfg.logging else None,
                           write=_writer(mesh))
    logger.set_summary(model_name=cfg.model, total_parameters=n_params)
    try:
        if cfg.evaluate:
            result = evaluate(ctx, logger)
            if ctx["random_init"]:
                # the protocol ran on fresh weights: tables downstream must
                # say so, not just the stderr line
                result["random_init"] = True
                logger.set_summary(random_init=True)
        else:
            result = train(ctx, logger)
    finally:
        logger.finish()
    if _writer(mesh):
        print(f"run {run_name}: " + ", ".join(
            f"{k}={v}" for k, v in result.items()), file=sys.stderr)
    return {"run_name": run_name, **result}


def main(argv: Optional[list] = None) -> None:
    cfg = merge_cli(load_config(DEFAULT_CONFIG), argv)
    run(cfg)


if __name__ == "__main__":
    main()
