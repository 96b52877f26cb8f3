"""Train and eval steps (replaces ``stofnet_tpu/train/steps.py`` and the
fused train step of ``bench.py``'s training memory walk).

A step updates the parameters in place: forward, loss, backward, one AdamW
update, the learning-rate schedule stepped once. The module path
(``make_train_step``) differentiates any model of the registry: heatmap
models on the blurred-mask loss, regression models (``model_kind``) on
the MSE to the first valid ToA. BatchNorm models train in
``module.train()`` (their running statistics update in place, f32 buffers
also under ``amp``, chained through the micro-batches of ``accum``) and
evaluate in ``module.eval()``; Kuleshov's dropout draws from a generator
seeded by the run's seed and the step. The fused path
(``make_fused_train_step``) trains StofNet through
``models/fused.py:stofnet_apply_fused(trainable=True)``, whose contract
conv + pool runs as the trainable SGB kernels on the card.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterable, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from stofnet_tpu_torch.models.batchnorm import BatchNorm
from stofnet_tpu_torch.models.fused import stofnet_apply_fused
from stofnet_tpu_torch.ops.conv import full_f32
from stofnet_tpu_torch.ops.gaussian import gaussian_kernel
from stofnet_tpu_torch.ops.peaks import mask2coords
from stofnet_tpu_torch.parallel.seq import SeqPlan
from stofnet_tpu_torch.train.loss import (
    blurred_mask, heatmap_loss, regression_loss,
)
from stofnet_tpu_torch.train.metrics import toa_rmse
from stofnet_tpu_torch.utils.collectives import (
    all_reduce, average_gradients, gather_rows, global_mean,
)


class LossConfig(NamedTuple):
    """Loss and decode hyperparameters, as the JAX package's."""

    kernel_size: int = 7
    sigma: float = 1.0
    mask_amplitude: float = 20.0
    lambda_value: float = 1e-2
    nms_win_size: int = 20
    th: Optional[float] = None
    etol: float = 1.0
    upsample_factor: int = 4
    max_echoes: int = 64
    model_kind: str = "heatmap"  # "heatmap" | "regression"


def make_optimizer(params: Iterable[torch.Tensor], lr: float = 5e-4,
                   weight_decay: float = 1e-8, epochs: int = 80,
                   steps_per_epoch: int = 1):
    """AdamW with cosine annealing stepped once per epoch: (optimizer,
    scheduler).

    ``torch.optim.AdamW`` makes the update of ``optax.adamw`` (b1 0.9, b2
    0.999, eps 1e-8 added outside the square root, decay decoupled and
    applied to the parameter before the step, scaled by the learning
    rate). The scheduler is stepped once per optimizer step, so update n
    runs at ``lr * 0.5 * (1 + cos(pi * epoch / epochs))`` with ``epoch =
    min(n // steps_per_epoch, epochs)``: constant within an epoch, as the
    JAX package's count-based schedule."""
    def factor(step: int) -> float:
        epoch = min(step // steps_per_epoch, epochs)
        return 0.5 * (1.0 + math.cos(math.pi * epoch / epochs))

    optimizer = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999),
                                  eps=1e-8, weight_decay=weight_decay)
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, factor)


def resume_optimizer(optimizer: torch.optim.Optimizer, scheduler,
                     saved: Mapping, step: int) -> None:
    """Resume ``optimizer`` and ``scheduler`` of :func:`make_optimizer` at
    update ``step`` with the moments of ``saved`` (an optimizer's
    ``state_dict``). The hyperparameters and the schedule stay this run's,
    as the JAX package restores optax's state under the optimizer built
    from the run's config: the learning rate is this schedule's at
    ``step``, also where the saved run annealed over other epochs."""
    sd = optimizer.state_dict()
    sd["state"] = saved["state"]
    optimizer.load_state_dict(sd)
    scheduler.last_epoch = int(step)
    for g, base, factor in zip(optimizer.param_groups, scheduler.base_lrs,
                               scheduler.lr_lambdas):
        g["lr"] = base * factor(int(step))


def _update(optimizer, scheduler, update_scale) -> None:
    """One optimizer step, then the schedule. ``update_scale`` multiplies
    this step's update; for AdamW that is exactly a learning-rate factor
    (the decay term is scaled by the learning rate too)."""
    lrs = [g["lr"] for g in optimizer.param_groups]
    if update_scale is not None:
        for g in optimizer.param_groups:
            g["lr"] = g["lr"] * float(update_scale)
    optimizer.step()
    for g, lr in zip(optimizer.param_groups, lrs):
        g["lr"] = lr
    if scheduler is not None:
        scheduler.step()


def _heatmap_loss(cfg: LossConfig, kernel: torch.Tensor):
    def loss_fn(pred, gt_true, norm_max=None, span=None):
        return heatmap_loss(pred, gt_true, kernel=kernel,
                            mask_amplitude=cfg.mask_amplitude,
                            lambda_value=cfg.lambda_value,
                            norm_max=norm_max, span=span)[0]
    return loss_fn


def _loss(cfg: LossConfig, kernel: torch.Tensor):
    """``loss_fn(pred, gt_sample, gt_true, norm_max=None, span=None)`` of
    the model kind: the regression target is the first valid ToA of
    ``gt_sample``, its validity from ``gt_true`` in input units; a heatmap
    over ``span`` is a length shard's (``heatmap_loss``)."""
    if cfg.model_kind == "regression":
        def loss_fn(pred, gt_sample, gt_true, norm_max=None, span=None):
            gt_units = (gt_true.reshape(gt_sample.shape)
                        // cfg.upsample_factor)
            return regression_loss(pred, gt_sample, gt_units)[0]
        return loss_fn
    heat = _heatmap_loss(cfg, kernel)
    return lambda pred, gt_sample, gt_true, norm_max=None, span=None: heat(
        pred, gt_true, norm_max, span)


def _seq_plan(model: nn.Module, mesh) -> Optional[SeqPlan]:
    """The model's length-shard plan where ``mesh`` shards the sample axis
    (sp > 1), else None."""
    if mesh is None or mesh.sp == 1:
        return None
    return SeqPlan(model, mesh)


def model_device(model: nn.Module) -> torch.device:
    """The device of a model's first parameter or buffer, else its
    ``device`` attribute (GradPeak has neither)."""
    for t in (*model.parameters(), *model.buffers()):
        return t.device
    return torch.device(model.device)


def dropout_seed(seed: int, step: int, micro: int = 0) -> int:
    """The dropout generator's seed of ``step`` (and micro-batch
    ``micro``) of a run seeded ``seed``: JAX folds the step into its
    dropout key, the port folds it into the generator's seed."""
    return int(np.random.SeedSequence([seed, step, micro]).generate_state(
        1, np.uint64)[0] >> 1)


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    scheduler, cfg: LossConfig, remat: bool = False,
                    amp: bool = False, accum: int = 1, seed: int = 0,
                    mesh=None):
    """``train_step(frame, gt_sample, gt_true, update_scale=None) ->
    {"loss": ...}`` over ``model``'s parameters, the model in train mode.

    ``amp=True`` casts the parameters (f32 masters) and the frame to bf16
    inside the differentiated function, runs the module in bf16 and the
    loss in f32: gradients come back in f32 and AdamW's state stays f32.
    BatchNorm's running statistics are buffers, not parameters, so they
    stay f32, as JAX casts its ``batch_stats`` back. The module must have
    ``dtype=None``. ``remat=True`` recomputes the forward in the backward
    (``torch.utils.checkpoint``); the recomputation's BatchNorm update is
    undone, so the statistics move once a step, as under ``jax.checkpoint``.
    ``accum=N`` splits the batch into N micro-batches whose gradients are
    averaged before one update; a heatmap loss takes the blurred mask's
    normalizer, the one batch-global quantity, over the full batch, so the
    step equals the full-batch step up to the order of sums; BatchNorm
    statistics chain through the micro-batches in order. A model with
    ``has_dropout`` (Kuleshov) gets a generator on its device seeded by
    ``dropout_seed(seed, step, micro_batch)``, ``step`` the scheduler's
    count of updates (the resumed count after ``resume_optimizer``).

    The f32 step (``amp=False``) runs under ``ops/conv.full_f32``: every
    conv and matmul of the forward, of ``remat``'s recomputed forward and
    of the backward of each micro-batch computes without TF32, as JAX's
    f32 step sums, and the caller's flags come back after the update.
    cuDNN reads the flags when each call is launched, so the block holds
    the backward too.

    ``mesh`` (``parallel/mesh.Mesh`` over a live process group): the step
    takes this rank's shard of the batch and computes the global batch's
    step, as JAX's step under GSPMD: the heatmap loss divides by the
    blurred mask's maximum over the global batch (an all-reduced max, also
    under ``accum``); BatchNorm's statistics are the global batch's
    (``models/batchnorm.py``); the gradients are summed over the ranks and
    divided by dp before the update (shards are equal, so that is the
    global mean); Kuleshov's masks are drawn for the global batch from the
    step's generator and each rank keeps its rows, the single process's
    masks. The returned loss is the global batch's, on every rank. Under
    ``accum`` each rank's batch must hold its slice of each of JAX's
    micro-batches in order (the rows ``utils/collectives.accum_rows``
    chooses, which ``DataLoader(accum=)`` and
    ``parallel/mesh.shard_batch(accum=)`` take): chunk i of every rank is
    then JAX's micro-batch i, global rows ``[i B / N, (i + 1) B / N)``,
    for BatchNorm's statistics and the masks.

    A mesh with sp > 1 shards the sample axis too, by the family's rule
    (``parallel/seq.SeqPlan``): the step takes this rank's L / sp samples
    of its rows, widens them with the neighbours' halo (once a step,
    without gradient; Kuleshov instead fetches each layer's halo inside
    autograd), runs the model as that shard (BatchNorm's statistics on
    its own positions, summed over every rank) and keeps its own
    positions. A heatmap loss is over those positions, against the GT
    mask built there from the global coordinates (``heatmap_loss(span=)``),
    the normaliser the maximum over every rank; Zonzini's prediction is
    the row's, joined over the sp group, so its loss counts each row once
    on every rank of the group. The gradients are the mean over all dp x
    sp ranks: each rank's is its equal share of the global mean.
    """
    device = model_device(model)
    kernel = gaussian_kernel(cfg.kernel_size, cfg.sigma, device=device)
    loss_fn = _loss(cfg, kernel)
    dropout = getattr(model, "has_dropout", False)
    stats = [b for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))]
    count = [0]  # updates made, where there is no scheduler
    params = [p for p in model.parameters() if p.requires_grad]
    plan = _seq_plan(model, mesh)
    for m in model.modules():  # None clears an earlier step's mesh
        if isinstance(m, BatchNorm):
            m.mesh = mesh

    def masks_of(generator):
        """The dropout masks' source: under a mesh, the global batch's
        masks drawn from ``generator``, this rank's rows kept."""
        if mesh is None or generator is None:
            return generator

        def draw(shape):
            b = shape[0]
            full = model.keep_mask((b * mesh.dp, *shape[1:]), generator,
                                   device)
            return full[mesh.dp_index * b:(mesh.dp_index + 1) * b]
        return draw

    def forward(frame, generator, shard=None):
        kw = {"generator": masks_of(generator)} if dropout else {}

        def run(x, **more):
            if not amp:
                return model(x, **kw, **more)
            p16 = {k: v.to(torch.bfloat16)
                   for k, v in model.named_parameters()}
            pred = torch.func.functional_call(
                model, p16, (x.to(torch.bfloat16),), {**kw, **more})
            return pred.to(torch.float32)
        if shard is None:
            return run(frame)
        return plan.forward(run, frame, shard)  # a length shard's own

    def loss_of(frame, gt_sample, gt_true, generator, norm_max=None,
                shard=None, span=None):
        if remat:
            # the recomputed forward draws the first one's dropout masks
            state = None if generator is None else generator.get_state()

            def again(f):
                if generator is not None:
                    generator.set_state(state)
                return forward(f, generator, shard)
            pred = checkpoint(again, frame, use_reentrant=False)
        else:
            pred = forward(frame, generator, shard)
        return loss_fn(pred, gt_sample, gt_true, norm_max, span)

    def backward(loss):
        kept = [b.clone() for b in stats] if remat else ()
        loss.backward()
        with torch.no_grad():
            for b, v in zip(stats, kept):
                b.copy_(v)

    def train_step(frame, gt_sample, gt_true, update_scale=None):
        with contextlib.nullcontext() if amp else full_f32():
            return step(frame, gt_sample, gt_true, update_scale)

    def generator(micro: int) -> Optional[torch.Generator]:
        if not dropout:
            return None
        n = scheduler.last_epoch if scheduler is not None else count[0]
        return torch.Generator(device=device).manual_seed(
            dropout_seed(seed, n, micro))

    def step(frame, gt_sample, gt_true, update_scale):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        if accum > 1 and frame.shape[0] % accum:
            raise ValueError(f"batch {frame.shape[0]} not divisible by "
                             f"accum={accum}")
        norm_max = shard = span = None
        up = cfg.upsample_factor
        length = frame.shape[-1] * up
        if plan is not None:
            n = frame.shape[-1]
            frame, shard = plan.shard(frame)
            length = n * mesh.sp * up
            if plan.heatmap:
                span = (mesh.sp_index * n * up, length)
        if cfg.model_kind != "regression" and (accum > 1
                                               or mesh is not None):
            norm_max = global_norm_max(cfg, kernel, gt_true, length, mesh,
                                       None if span is None else span[0])
        if accum <= 1:
            loss = loss_of(frame, gt_sample, gt_true, generator(0), norm_max,
                           shard, span)
            backward(loss)
        else:
            loss = torch.zeros((), device=device)
            parts = zip(frame.chunk(accum), gt_sample.chunk(accum),
                        gt_true.chunk(accum))
            for i, (f, gs, gtr) in enumerate(parts):
                part = loss_of(f, gs, gtr, generator(i), norm_max, shard,
                               span)
                backward(part / accum)
                loss = loss + part.detach()
            loss = loss / accum
        loss = loss.detach()
        if mesh is not None:
            average_gradients(mesh, params)
            loss = global_mean(mesh, loss)
        _update(optimizer, scheduler, update_scale)
        count[0] += 1
        return {"loss": loss}

    return train_step


def global_norm_max(cfg: LossConfig, kernel: torch.Tensor,
                    gt_true: torch.Tensor, length: int,
                    mesh=None, start: Optional[int] = None) -> torch.Tensor:
    """The blurred mask's maximum over the batch (masks of ``length``),
    the heatmap loss's normaliser; over the global batch under ``mesh``
    (an all-reduced max over every rank), each rank's over its length /
    sp positions from ``start`` where it holds a length shard."""
    span = None if start is None else (start, start + length // mesh.sp)
    norm_max = blurred_mask(gt_true, length, kernel, span)[1].max()
    if mesh is None:
        return norm_max
    return all_reduce(mesh, norm_max, "max")


def make_eval_finish(cfg: LossConfig, device, mesh=None):
    """``finish(pred, gt_sample, gt_true) -> dict`` of ``loss``,
    ``es_sample``, ``toa_metrics`` and ``masks_pred`` of a computed
    prediction on ``device``, without gradients: the second half of
    :func:`make_eval_step`, also the array eval's
    (``parallel/array.py``). Under ``mesh`` each rank finishes its shard
    and every output is the global batch's: the loss with the global
    normaliser and averaged over the ranks, the rest gathered in batch
    order."""
    kernel = gaussian_kernel(cfg.kernel_size, cfg.sigma, device=device)
    loss_fn = _loss(cfg, kernel)

    @torch.no_grad()
    def finish(pred, gt_sample, gt_true) -> Dict[str, torch.Tensor]:
        if mesh is None:
            return local(pred, gt_sample, gt_true)
        norm_max = None
        if cfg.model_kind != "regression":
            norm_max = global_norm_max(cfg, kernel, gt_true, pred.shape[-1],
                                       mesh)
        out = local(pred, gt_sample, gt_true, norm_max)
        return {k: global_mean(mesh, v) if k == "loss"
                else gather_rows(mesh, v)
                for k, v in out.items()}

    def local(pred, gt_sample, gt_true, norm_max=None):
        if cfg.model_kind == "regression":
            es_sample = pred.reshape(pred.shape[0], -1)
        else:
            es_sample = mask2coords(pred, window_size=cfg.nms_win_size,
                                    threshold=cfg.th,
                                    upsample_factor=cfg.upsample_factor,
                                    max_echoes=cfg.max_echoes)
        gs = gt_sample.reshape(gt_sample.shape[0], -1)
        with full_f32():
            loss = loss_fn(pred, gt_sample, gt_true, norm_max)
        return {"loss": loss, "es_sample": es_sample,
                "toa_metrics": toa_rmse(gs, es_sample, tol=cfg.etol),
                "masks_pred": pred}

    return finish


def make_eval_step(model: nn.Module, cfg: LossConfig, mesh=None):
    """``eval_step(frame, gt_sample, gt_true) -> dict`` of ``loss``,
    ``es_sample`` (decoded ToAs), ``toa_metrics`` ((B, 7), ``toa_rmse``)
    and ``masks_pred``: the model in eval mode, forward -> ``mask2coords``
    (a heatmap model) or the prediction itself reshaped to (B, n) (a
    regression model) -> loss -> ``toa_rmse``, without gradients, its
    convs under ``ops/conv.full_f32`` (an f32 module without TF32; a bf16
    one computes the same under it).

    The step also exposes its two halves, which ``cli/main.py`` times
    apart, as the JAX step does:

    - ``eval_step.forward(frame) -> (pred, checksum)``: the checksum is
      the prediction's f32 sum, whose copy to the host waits for the
      forward;
    - ``eval_step.finish(pred, gt_sample, gt_true) -> dict``: decode, loss
      and metrics of a computed prediction.

    Under ``mesh`` the forward is this rank's shard and the outputs are
    the global batch's (:func:`make_eval_finish`). With sp > 1 the
    forward takes this rank's L / sp samples of its rows and runs as that
    shard by its family's rule (``parallel/seq.SeqPlan``); a heatmap's
    shards are gathered over the sp group in sp order, Zonzini's and
    GradPeak's predictions are joined already: ``forward`` returns whole
    rows, which the decode reads (its NMS and ranking span the row), and
    the rest runs over the dp column as at sp = 1.
    """
    plan = _seq_plan(model, mesh)

    @torch.no_grad()
    def forward(frame) -> Tuple[torch.Tensor, torch.Tensor]:
        model.eval()
        with full_f32():
            if plan is None:
                pred = model(frame)
            else:
                x, shard = plan.shard(frame)
                pred = plan.join(plan.forward(model, x, shard))
        return pred, pred.float().sum()

    finish = make_eval_finish(cfg, model_device(model),
                              None if mesh is None else mesh.over_dp())

    def eval_step(frame, gt_sample, gt_true) -> Dict[str, torch.Tensor]:
        return finish(forward(frame)[0], gt_sample, gt_true)

    eval_step.forward = forward
    eval_step.finish = finish
    return eval_step


def fused_loss(params: Mapping[str, torch.Tensor], frame: torch.Tensor,
               gt_true: torch.Tensor, cfg: LossConfig,
               dtype: Optional[torch.dtype] = torch.bfloat16,
               forward=stofnet_apply_fused, **arch) -> torch.Tensor:
    """``heatmap_loss`` of ``forward(params, frame, trainable=True)``:
    differentiable in ``params``. ``forward`` is
    ``models.stofnet_apply_fused`` (the kernels on the card) or
    ``models.stofnet_apply_reference`` (the same forward through the
    kernels' plain versions, on any device)."""
    pred = forward(params, frame, dtype=dtype, trainable=True,
                   upsample_factor=cfg.upsample_factor, **arch)
    kernel = gaussian_kernel(cfg.kernel_size, cfg.sigma, device=frame.device)
    return _heatmap_loss(cfg, kernel)(pred, gt_true)


def make_fused_train_step(params: Mapping[str, torch.Tensor],
                          optimizer: torch.optim.Optimizer, scheduler,
                          cfg: LossConfig,
                          dtype: Optional[torch.dtype] = torch.bfloat16,
                          forward=stofnet_apply_fused, **arch):
    """``step(frame, gt_true) -> loss``: the fused train step (the
    ``fused_step`` of ``bench.py``'s training memory walk).
    :func:`fused_loss` of ``forward`` in ``dtype`` (bf16 forward, the f32
    masters cast inside it), backward, one AdamW update of ``params``
    (name -> f32 ``nn.Parameter``, the StofNet module's names, e.g.
    ``dict(StofNet(...).named_parameters())``). ``arch`` takes
    ``num_blocks`` and ``semi_global_scale``."""
    def step(frame, gt_true):
        optimizer.zero_grad(set_to_none=True)
        loss = fused_loss(params, frame, gt_true, cfg, dtype, forward, **arch)
        loss.backward()
        _update(optimizer, scheduler, None)
        return loss.detach()

    return step
