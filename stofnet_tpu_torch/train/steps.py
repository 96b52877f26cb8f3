"""Train and eval steps (replaces ``stofnet_tpu/train/steps.py`` and the
fused train step of ``bench.py``'s training memory walk).

A step updates the parameters in place: forward, blurred-mask loss,
backward, one AdamW update, the learning-rate schedule stepped once. The
module path (``make_train_step``) differentiates any ``nn.Module``; the
fused path (``make_fused_train_step``) trains StofNet through
``models/fused.py:stofnet_apply_fused(trainable=True)``, whose contract
conv + pool runs as the trainable SGB kernels on the card.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterable, Mapping, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from stofnet_tpu_torch.models.fused import stofnet_apply_fused
from stofnet_tpu_torch.ops.conv import full_f32
from stofnet_tpu_torch.ops.gaussian import gaussian_kernel
from stofnet_tpu_torch.ops.peaks import mask2coords
from stofnet_tpu_torch.train.loss import blurred_mask, heatmap_loss
from stofnet_tpu_torch.train.metrics import toa_rmse


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
    def loss_fn(pred, gt_true, norm_max=None):
        return heatmap_loss(pred, gt_true, kernel=kernel,
                            mask_amplitude=cfg.mask_amplitude,
                            lambda_value=cfg.lambda_value,
                            norm_max=norm_max)[0]
    return loss_fn


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    scheduler, cfg: LossConfig, remat: bool = False,
                    amp: bool = False, accum: int = 1):
    """``train_step(frame, gt_sample, gt_true, update_scale=None) ->
    {"loss": ...}`` over ``model``'s parameters.

    ``amp=True`` casts the parameters (f32 masters) and the frame to bf16
    inside the differentiated function, runs the module in bf16 and the
    loss in f32: gradients come back in f32 and AdamW's state stays f32.
    The module must have ``dtype=None``. ``remat=True`` recomputes the
    forward in the backward (``torch.utils.checkpoint``). ``accum=N``
    splits the batch into N micro-batches whose gradients are averaged
    before one update; the blurred mask's normalizer, the one batch-global
    quantity of the loss, is taken over the full batch and passed to every
    micro-batch, so the step equals the full-batch step up to the order of
    sums. ``gt_sample`` is unused by the heatmap loss and kept for the
    signature of the JAX step.

    The f32 step (``amp=False``) runs under ``ops/conv.full_f32``: every
    conv of the forward, of ``remat``'s recomputed forward and of the
    backward of each micro-batch computes without TF32, as JAX's f32 step
    sums, and the caller's flags come back after the update. cuDNN reads
    the flags when each call is launched, so the block holds the backward
    too.
    """
    device = next(model.parameters()).device
    kernel = gaussian_kernel(cfg.kernel_size, cfg.sigma, device=device)
    loss_fn = _heatmap_loss(cfg, kernel)

    def forward(frame):
        if not amp:
            return model(frame)
        p16 = {k: v.to(torch.bfloat16) for k, v in model.named_parameters()}
        pred = torch.func.functional_call(model, p16,
                                          (frame.to(torch.bfloat16),))
        return pred.to(torch.float32)

    def loss_of(frame, gt_true, norm_max=None):
        pred = (checkpoint(forward, frame, use_reentrant=False) if remat
                else forward(frame))
        return loss_fn(pred, gt_true, norm_max)

    def train_step(frame, gt_sample, gt_true, update_scale=None):
        with contextlib.nullcontext() if amp else full_f32():
            return step(frame, gt_true, update_scale)

    def step(frame, gt_true, update_scale):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        if accum <= 1:
            loss = loss_of(frame, gt_true)
            loss.backward()
        else:
            if frame.shape[0] % accum:
                raise ValueError(f"batch {frame.shape[0]} not divisible by "
                                 f"accum={accum}")
            l_out = frame.shape[-1] * cfg.upsample_factor
            norm_max = blurred_mask(gt_true, l_out, kernel)[1].max()
            loss = torch.zeros((), device=device)
            for f, gtr in zip(frame.chunk(accum), gt_true.chunk(accum)):
                part = loss_of(f, gtr, norm_max)
                (part / accum).backward()
                loss = loss + part.detach()
            loss = loss / accum
        _update(optimizer, scheduler, update_scale)
        return {"loss": loss.detach()}

    return train_step


def make_eval_step(model: nn.Module, cfg: LossConfig):
    """``eval_step(frame, gt_sample, gt_true) -> dict`` of ``loss``,
    ``es_sample`` (decoded ToAs), ``toa_metrics`` ((B, 7), ``toa_rmse``)
    and ``masks_pred``: forward -> ``mask2coords`` -> loss -> ``toa_rmse``,
    without gradients, its convs under ``ops/conv.full_f32`` (an f32
    module without TF32; a bf16 one computes the same under it).

    The step also exposes its two halves, which ``cli/main.py`` times
    apart, as the JAX step does:

    - ``eval_step.forward(frame) -> (pred, checksum)``: the checksum is
      the heatmap's f32 sum, whose copy to the host waits for the forward;
    - ``eval_step.finish(pred, gt_sample, gt_true) -> dict``: decode, loss
      and metrics of a computed heatmap.
    """
    device = next(model.parameters()).device
    kernel = gaussian_kernel(cfg.kernel_size, cfg.sigma, device=device)
    loss_fn = _heatmap_loss(cfg, kernel)

    @torch.no_grad()
    def forward(frame) -> Tuple[torch.Tensor, torch.Tensor]:
        model.eval()
        with full_f32():
            pred = model(frame)
        return pred, pred.float().sum()

    @torch.no_grad()
    def finish(pred, gt_sample, gt_true) -> Dict[str, torch.Tensor]:
        es_sample = mask2coords(pred, window_size=cfg.nms_win_size,
                                threshold=cfg.th,
                                upsample_factor=cfg.upsample_factor,
                                max_echoes=cfg.max_echoes)
        gs = gt_sample.reshape(gt_sample.shape[0], -1)
        with full_f32():
            loss = loss_fn(pred, gt_true)
        return {"loss": loss, "es_sample": es_sample,
                "toa_metrics": toa_rmse(gs, es_sample, tol=cfg.etol),
                "masks_pred": pred}

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
