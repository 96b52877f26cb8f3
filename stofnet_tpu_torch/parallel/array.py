"""Job arrays: N same-architecture members as one program (replaces
``stofnet_tpu/parallel/array.py``).

The reference runs one process a row of its SLURM job arrays
(``bash_scripts/chirp_benchmark.sh:14``, ``train_pala_array.sh:14``): a
(model, checkpoint, threshold) row, a training seed, a learning rate.
Here the members ride one process with a leading *member* axis on every
parameter and buffer, and ``torch.func.vmap`` runs the member's function
over it through ``torch.func.functional_call`` on one module of the
architecture (on the meta device: it holds no data).

- Training (:func:`make_array_train_step`): the vmapped loss of each
  member, then the autograd engine's backward of the members' summed loss.
  Members share no parameter, so that gradient is, member by member, each
  member's own (``torch.func.vmap(torch.func.grad(...))`` computes the
  same; the tests hold both), and unlike ``torch.func.grad`` it composes
  with ``torch.utils.checkpoint`` for ``remat``. One AdamW over the
  stacked tensors is N independent AdamWs: its update is elementwise.
- A member is a normal model: :meth:`ArrayState.member` is its state dict
  (``load_state_dict``, ``train/checkpoint.py``, ``cli/main.py
  evaluate=True``, ``cli/export.py`` take it) and
  :func:`member_optimizer_state` its AdamW state in ``torch.optim``'s
  layout.
- Threshold sweeps run the model once (:func:`make_threshold_sweep_step`):
  one forward, the decode and metrics vmapped over a (T,) threshold tensor
  (``ops/peaks.threshold_scores`` takes a tensor as a fixed threshold).

Per-member weights make every conv a grouped conv under ``vmap``: members
do not merge into larger contractions, so on one card the array saves
processes, loads and launches, not compute. Members ride a mesh's dp axis
(:func:`shard_members`): each rank keeps its N / dp members.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import torch
from torch import nn
from torch.func import functional_call, vmap
from torch.utils.checkpoint import checkpoint

from stofnet_tpu_torch.ops.conv import full_f32
from stofnet_tpu_torch.ops.gaussian import gaussian_kernel
from stofnet_tpu_torch.ops.peaks import mask2coords
from stofnet_tpu_torch.parallel.mesh import Mesh, shard_batch
from stofnet_tpu_torch.train.loss import blurred_mask
from stofnet_tpu_torch.train.metrics import toa_rmse
from stofnet_tpu_torch.train.steps import (
    LossConfig, _loss, dropout_seed, make_eval_finish,
)

Tree = Dict[str, torch.Tensor]


def stack_trees(trees: Sequence[Mapping[str, torch.Tensor]]) -> Tree:
    """Identically keyed state dicts stacked along a new leading member
    axis."""
    if not trees:
        raise ValueError("stack_trees needs at least one tree")
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def unstack_tree(tree: Mapping[str, torch.Tensor], member: int) -> Tree:
    """One member's state dict (the inverse of :func:`stack_trees`)."""
    return {k: v[member] for k, v in tree.items()}


def n_members(tree: Mapping[str, torch.Tensor]) -> int:
    """The member count: the leading size of the first tensor."""
    for v in tree.values():
        return int(v.shape[0])
    raise ValueError("empty tree has no member axis")


@dataclass
class ArrayState:
    """N members of one architecture: ``params`` (leaves that require
    gradients) and ``buffers``, name -> (N, ...) tensor, in the module's
    order; ``model`` runs one member through ``functional_call``."""

    model: nn.Module
    params: Tree
    buffers: Tree
    seeds: List[int]

    def variables(self) -> Tree:
        """The stacked state dict, detached (what the array eval takes)."""
        return {k: v.detach() for k, v in {**self.params,
                                           **self.buffers}.items()}

    def member(self, i: int) -> Tree:
        """Member ``i``'s state dict in the module's key order."""
        every = self.variables()
        return {k: every[k][i] for k in self.model.state_dict()}


def shard_members(mesh: Mesh, tree):
    """This rank's members of ``tree`` over the mesh's dp axis: the member
    axis is the leading axis of every stacked leaf, which
    ``parallel/mesh.shard_batch`` shards, so rank r keeps members r * N /
    dp onwards. An :class:`ArrayState` keeps its members' parameters (new
    leaves that require gradients), buffers and seeds."""
    if not isinstance(tree, ArrayState):
        return shard_batch(mesh, dict(tree))
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in shard_batch(mesh, tree.params).items()}
    buffers = {k: v.clone() for k, v in
               shard_batch(mesh, tree.buffers).items()}
    return ArrayState(tree.model, params, buffers,
                      list(shard_batch(mesh, torch.tensor(tree.seeds))
                           .tolist()))


def init_array_state(build: Callable[[torch.Generator], nn.Module],
                     seeds: Sequence[int], *,
                     allow_duplicate_seeds: bool = False) -> ArrayState:
    """Members ``build(torch.Generator().manual_seed(s))`` for each seed,
    stacked: member i is the model a solo run with seed ``s_i`` draws
    (``cli/main.setup``). Fresh AdamW state is
    ``train.make_optimizer(state.params.values(), ...)``.

    ``allow_duplicate_seeds`` is for members that differ by something
    other than their init: a learning-rate sweep starts every member from
    one init, so that it isolates the rate."""
    seeds = [int(s) for s in seeds]
    if len(set(seeds)) != len(seeds) and not allow_duplicate_seeds:
        raise ValueError(f"duplicate seeds in {seeds}: members would be "
                         f"bit-identical copies (pass "
                         f"allow_duplicate_seeds=True only when per-member "
                         f"lr_scales differentiate them)")
    params = buffers = None
    for i, seed in enumerate(seeds):
        model = build(torch.Generator().manual_seed(seed))
        p = dict(model.named_parameters())
        b = dict(model.named_buffers())
        if params is None:  # one member alive at a time beside the stacks
            params = {k: v.new_empty((len(seeds), *v.shape))
                      for k, v in p.items()}
            buffers = {k: v.new_empty((len(seeds), *v.shape))
                       for k, v in b.items()}
        with torch.no_grad():
            for k, v in p.items():
                params[k][i] = v
            for k, v in b.items():
                buffers[k][i] = v
    for v in params.values():
        v.requires_grad_(True)
    return ArrayState(model.to("meta"), params, buffers, seeds)


def member_optimizer_state(optimizer: torch.optim.Optimizer, member: int,
                           lr_scale: float = 1.0) -> Dict[str, Any]:
    """Member ``member``'s share of an optimizer over an
    :class:`ArrayState`'s ``params``: a ``state_dict`` in the layout of an
    optimizer over one model's parameters (``cli/main.py``'s ``resume=``
    takes it), the learning rates times ``lr_scale``."""
    sd = optimizer.state_dict()
    state = {j: {k: v if k == "step" else v[member] for k, v in s.items()}
             for j, s in sd["state"].items()}
    groups = [{k: v * lr_scale if k in ("lr", "initial_lr") else v
               for k, v in g.items()} for g in sd["param_groups"]]
    return {"state": state, "param_groups": groups}


def _dropout_shapes(state: ArrayState, frame_shape) -> List[tuple]:
    """The shapes of a member's dropout masks, in the order its forward
    draws them: a forward on the meta device that records them."""
    shapes: List[tuple] = []

    def record(shape):
        shapes.append(tuple(shape))
        return torch.ones(shape, dtype=torch.bool, device="meta")

    meta = {k: torch.empty(v.shape[1:], dtype=v.dtype, device="meta")
            for k, v in state.variables().items()}
    with torch.no_grad():
        functional_call(state.model, meta,
                        (torch.empty(frame_shape, device="meta"),),
                        {"generator": record})
    return shapes


def make_array_train_step(state: ArrayState,
                          optimizer: torch.optim.Optimizer, scheduler,
                          cfg: LossConfig, *, remat: bool = False,
                          amp: bool = False, accum: int = 1,
                          per_member_data: bool = False,
                          lr_scales: Optional[Sequence[float]] = None):
    """``step(frame, gt_sample, gt_true) -> {"loss": (N,)}``: one train
    step of every member, in place on ``state`` and ``optimizer``
    (``train.make_optimizer`` over ``state.params.values()``).

    Each member takes the solo ``train/steps.make_train_step``'s step:
    the loss of its kind, ``amp`` (bf16 parameters and frame inside the
    loss, f32 masters and buffers), ``remat`` (``torch.utils.checkpoint``
    around the vmapped loss; BatchNorm statistics move once a step),
    ``accum`` (micro-batches, the blurred mask's normalizer over the full
    batch), BatchNorm statistics of its own, dropout masks from
    ``dropout_seed(seed_i, step, micro)`` as its solo run draws them (drawn
    ahead and taken into the vmapped loss), the f32 step under
    ``ops/conv.full_f32``. With ``per_member_data`` the data carry their
    own leading member axis; else every member sees the same batch.

    ``lr_scales`` (one float a member) runs member i at ``lr_scales[i]``
    times the learning rate: its whole AdamW update, decay included, is
    scaled, which for AdamW is the update at ``lr * lr_scales[i]``."""
    model = state.model
    params = list(state.params.values())
    device = params[0].device
    n = len(state.seeds)
    kernel = gaussian_kernel(cfg.kernel_size, cfg.sigma, device=device)
    loss_fn = _loss(cfg, kernel)
    data_ax = 0 if per_member_data else None
    dropout = getattr(model, "has_dropout", False)
    stats = [v for k, v in state.buffers.items()
             if k.endswith(("running_mean", "running_var"))]
    scales = None
    if lr_scales is not None:
        if len(lr_scales) != n:
            raise ValueError(f"{len(lr_scales)} lr_scales for {n} members")
        scales = torch.tensor([float(s) for s in lr_scales],
                              dtype=torch.float32, device=device)
    shapes: Dict[tuple, List[tuple]] = {}

    def member_loss(p, b, frame, gt_sample, gt_true, norm_max, masks):
        kw = {}
        if masks is not None:
            it = iter(masks)
            kw["generator"] = lambda shape: next(it)
        if amp:
            p = {k: v.to(torch.bfloat16) for k, v in p.items()}
            frame = frame.to(torch.bfloat16)
        pred = functional_call(model, (p, b), (frame,), kw)
        return loss_fn(pred.to(torch.float32), gt_sample, gt_true, norm_max)

    def masks_of(frame_shape, micro: int):
        """Each dropout site's masks, (N, ...): member i's from its
        generator, in its solo order."""
        if frame_shape not in shapes:
            shapes[frame_shape] = _dropout_shapes(state, frame_shape)
        step = scheduler.last_epoch
        drawn = []
        for seed in state.seeds:
            g = torch.Generator(device=device).manual_seed(
                dropout_seed(seed, step, micro))
            drawn.append([model.keep_mask(s, g, device)
                          for s in shapes[frame_shape]])
        return [torch.stack(site) for site in zip(*drawn)]

    def losses_of(frame, gt_sample, gt_true, norm_max, micro):
        member_shape = tuple(frame.shape[1:] if per_member_data
                             else frame.shape)
        masks = masks_of(member_shape, micro) if dropout else None
        in_dims = (0, 0, data_ax, data_ax, data_ax,
                   None if norm_max is None or norm_max.ndim == 0 else 0,
                   None if masks is None else 0)
        vloss = vmap(member_loss, in_dims=in_dims)
        args = (state.params, state.buffers, frame, gt_sample, gt_true,
                norm_max, masks)
        if remat:
            return checkpoint(vloss, *args, use_reentrant=False)
        return vloss(*args)

    def backward(total):
        kept = [b.clone() for b in stats] if remat else ()
        total.backward()
        with torch.no_grad():
            for b, v in zip(stats, kept):
                b.copy_(v)

    def update():
        before = ([p.detach().clone() for p in params]
                  if scales is not None else ())
        optimizer.step()
        with torch.no_grad():
            for p, b in zip(params, before):
                s = scales.view(-1, *([1] * (p.ndim - 1)))
                p.copy_(torch.lerp(b, p, s))
        if scheduler is not None:
            scheduler.step()

    def step(frame, gt_sample, gt_true):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        if accum <= 1:
            losses = losses_of(frame, gt_sample, gt_true, None, 0)
            backward(losses.sum())
            losses = losses.detach()
        else:
            bax = 1 if per_member_data else 0
            if frame.shape[bax] % accum:
                raise ValueError(f"batch {frame.shape[bax]} not divisible "
                                 f"by accum={accum}")
            norm_max = None
            if cfg.model_kind != "regression":
                l_out = frame.shape[-1] * cfg.upsample_factor
                gts = gt_true if per_member_data else [gt_true]
                norm_max = torch.stack([blurred_mask(g, l_out, kernel)[1]
                                        .max() for g in gts])
                if not per_member_data:
                    norm_max = norm_max[0]
            losses = torch.zeros(n, device=device)
            parts = zip(frame.chunk(accum, bax), gt_sample.chunk(accum, bax),
                        gt_true.chunk(accum, bax))
            for i, (f, gs, gtr) in enumerate(parts):
                part = losses_of(f, gs, gtr, norm_max, i)
                backward(part.sum() / accum)
                losses = losses + part.detach()
            losses = losses / accum
        update()
        return {"loss": losses}

    def train_step(frame, gt_sample, gt_true) -> Dict[str, torch.Tensor]:
        with contextlib.nullcontext() if amp else full_f32():
            return step(frame, gt_sample, gt_true)

    return train_step


def make_array_eval_step(model: nn.Module, cfg: LossConfig, *,
                         keep_heatmaps: bool = False):
    """``aeval(stacked, frame, gt_sample, gt_true) -> dict`` of ``loss``
    (N,), ``es_sample`` (N, B, E) and ``toa_metrics`` (N, B, 7): the solo
    eval step (``train/steps.make_eval_step``: eval mode, the forward
    under ``full_f32``, decode, loss, ``toa_rmse``) of each member of the
    stacked state dict ``stacked`` on one shared batch. ``keep_heatmaps``
    also returns the (N, B, 1, L*r) ``masks_pred``."""
    finishers: Dict[torch.device, Callable] = {}

    @torch.no_grad()
    def aeval(stacked: Mapping[str, torch.Tensor], frame, gt_sample,
              gt_true) -> Dict[str, torch.Tensor]:
        model.eval()
        if frame.device not in finishers:
            finishers[frame.device] = make_eval_finish(cfg, frame.device)
        finish = finishers[frame.device]

        def one(sd):
            with full_f32():
                pred = functional_call(model, sd, (frame,))
            out = finish(pred, gt_sample, gt_true)
            if not keep_heatmaps:
                del out["masks_pred"]
            return out

        return vmap(one)(dict(stacked))

    return aeval


def make_threshold_sweep_step(model: nn.Module, cfg: LossConfig):
    """``sweep(variables, frame, gt_sample, gt_true, thresholds) -> dict``
    of ``es_sample`` (T, B, max_echoes) and ``toa_metrics`` (T, B, 7): one
    forward of the state dict ``variables`` (eval mode, under
    ``full_f32``), decoded at each of the (T,) tensor ``thresholds``. A
    tensor threshold is a fixed one (> 0); the per-row-max mode is the
    plain eval step's ``th=None``."""

    @torch.no_grad()
    def sweep(variables: Mapping[str, torch.Tensor], frame, gt_sample,
              gt_true, thresholds: torch.Tensor) -> Dict[str, torch.Tensor]:
        model.eval()
        with full_f32():
            pred = functional_call(model, dict(variables), (frame,))
        gs = gt_sample.reshape(gt_sample.shape[0], -1)

        def decode_at(th):
            es = mask2coords(pred, window_size=cfg.nms_win_size,
                             threshold=th,
                             upsample_factor=cfg.upsample_factor,
                             max_echoes=cfg.max_echoes)
            return {"es_sample": es,
                    "toa_metrics": toa_rmse(gs, es, tol=cfg.etol)}

        return vmap(decode_at)(thresholds)

    return sweep


def stack_checkpoint_variables(variables_list: Sequence[Mapping[str, Any]]
                               ) -> Tree:
    """N loaded state dicts of one architecture, stacked for the array
    eval. Raises where a checkpoint's names or shapes differ from the
    first's: different architectures cannot share one program."""
    if not variables_list:
        raise ValueError("no variables to stack")

    def shapes(v):
        return {k: tuple(t.shape) for k, t in v.items()}

    ref = shapes(variables_list[0])
    for i, v in enumerate(variables_list[1:], start=1):
        if shapes(v) != ref:
            raise ValueError(
                f"checkpoint {i} has a different architecture than "
                f"checkpoint 0: {shapes(v)} vs {ref}")
    return stack_trees(list(variables_list))
