"""The port's job arrays (``stofnet_tpu_torch/parallel/array.py``) and the
two repairs under them (``ops/poolgrad.py``, ``ops/peaks.py``), on the CPU.

Members of a port array are held against the same members trained or
evaluated alone in the port, and against JAX's array on the same weights
(JAX's stacked flax trees carried across with ``params_to_state_dict``).
Tolerances:
- ``maxpool_leaky`` under ``torch.func.vmap(torch.func.grad(...))``:
  gradients rtol 1e-5 (atol 1e-5 of the leaf's largest) against each
  member's autograd, rtol 1e-4 (atol 1e-4 of the largest) against JAX's
  ``jax.vmap(jax.grad(...))``;
- array against solo, per member: parameters after two steps rtol 2e-5,
  atol 1e-5 (``tests/test_array.py:86``), also for ``lr_scales`` against
  solo runs at ``lr * s`` (``:440-443``); BatchNorm members' statistics
  after one step rtol 1e-5, atol 1e-6 (``:268``), and their first
  gradients rtol 1e-4 (atol 1e-4 of the model's largest); Kuleshov's
  losses (its dropout masks member by member) rtol 1e-5;
- array against JAX's array: losses rtol 1e-4;
- the array eval against the solo eval and JAX's: ``es_sample`` rtol =
  atol = 1e-5, the loss rtol 1e-4 (``:121-123``);
- the threshold sweep against per-threshold decodes and against JAX's
  sweep: coords equal, metrics rtol 1e-5 (``:143-146``).
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from torch.func import functional_call, grad, vmap

from stofnet_tpu.models import StofNet as JaxStofNet
from stofnet_tpu.ops import peaks as jpeaks
from stofnet_tpu.parallel import array as jarray
from stofnet_tpu.train import loss as jloss
from stofnet_tpu.train import metrics as jmetrics
from stofnet_tpu.train import steps as jsteps
from stofnet_tpu_torch.models import StofNet, build_model
from stofnet_tpu_torch.models.torch_import import params_to_state_dict
from stofnet_tpu_torch.ops import peaks
from stofnet_tpu_torch.parallel import (
    init_array_state, make_array_eval_step, make_array_train_step,
    make_threshold_sweep_step, member_optimizer_state, n_members,
    stack_checkpoint_variables, stack_trees, unstack_tree,
)
from stofnet_tpu_torch.train import (
    LossConfig, heatmap_loss, make_eval_step, make_optimizer,
    make_train_step, toa_rmse,
)
from tests.test_torch_threads import share_cores

share_cores()  # this xdist worker's share of the cores

LENGTH = 800
ARCH = dict(num_features=16, num_blocks=3)
SEEDS = [0, 1, 2]
LR = 5e-4
CFG = dict(upsample_factor=4, max_echoes=8)


def _batch(seed=7, b=4, length=LENGTH):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 1, length)).astype(np.float32)
    gs = rng.uniform(50, length - 50, (b, 2)).astype(np.float32)
    gt = np.round(gs[:, None, :] * 4).astype(np.int32)
    return x, gs, gt


def _t(arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _build(g):
    return StofNet(generator=g, device="cpu", **ARCH)


def _array_run(build, seeds, batches, cfg=CFG, lr_scales=None, **kw):
    state = init_array_state(build, seeds,
                             allow_duplicate_seeds=lr_scales is not None)
    opt, sched = make_optimizer(state.params.values(), lr=LR,
                                steps_per_epoch=100)
    step = make_array_train_step(state, opt, sched, LossConfig(**cfg),
                                 lr_scales=lr_scales, **kw)
    losses = [step(*b)["loss"].numpy() for b in batches]
    return state, opt, np.stack(losses)


def _solo_run(build, seed, batches, cfg=CFG, lr=LR, **kw):
    model = build(torch.Generator().manual_seed(seed))
    opt, sched = make_optimizer(model.parameters(), lr=lr,
                                steps_per_epoch=100)
    step = make_train_step(model, opt, sched, LossConfig(**cfg), seed=seed,
                           **kw)
    losses = [step(*b)["loss"].item() for b in batches]
    grads = {k: p.grad.clone() for k, p in model.named_parameters()
             if p.grad is not None}
    return model, np.asarray(losses), grads


def _assert_member(state, i, model, rtol=2e-5, atol=1e-5):
    got = state.member(i)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=rtol,
                                   atol=atol, err_msg=k)


# --- Part 0: the repairs ----------------------------------------------------


def _stacked(models):
    return stack_trees([dict(m.named_parameters()) for m in models])


def _member_loss(model):
    def loss(params, x, gt):
        return heatmap_loss(functional_call(model, params, (x,)), gt)[0]
    return loss


def test_maxpool_leaky_vmap_grad_matches_member_autograd():
    """Repair: ``maxpool_leaky``'s autograd.Function had no
    ``setup_context``, so ``vmap(grad(...))`` over stacked StofNets raised.
    Now each member's gradient is its own autograd gradient."""
    x, _, gt = _t(_batch())
    models = [_build(torch.Generator().manual_seed(s)) for s in SEEDS]
    params = {k: v.detach() for k, v in _stacked(models).items()}
    g = vmap(grad(_member_loss(models[0])), in_dims=(0, None, None))(
        params, x, gt)
    for i, m in enumerate(models):
        heatmap_loss(m(x), gt)[0].backward()
        for k, p in m.named_parameters():
            ref = p.grad.numpy()
            np.testing.assert_allclose(g[k][i].numpy(), ref, rtol=1e-5,
                                       atol=1e-5 * np.abs(ref).max(),
                                       err_msg=(i, k))


def test_vmap_grad_matches_jax_vmap_grad():
    """The same three members' gradients in one ``vmap(grad(...))`` in
    each framework, from JAX's stacked flax init."""
    x, _, gt = _batch()
    jmodel = JaxStofNet(**ARCH)
    variables = [jmodel.init(jax.random.key(s), jnp.zeros((1, 1, LENGTH)))
                 for s in SEEDS]
    jstack = jarray.stack_trees([v["params"] for v in variables])

    def jloss_fn(p, x, gt):
        return jloss.heatmap_loss(jmodel.apply({"params": p}, x), gt)[0]

    jg = jax.jit(jax.vmap(jax.grad(jloss_fn), in_axes=(0, None, None)))(
        jstack, jnp.asarray(x), jnp.asarray(gt))
    model = StofNet(device="meta", **ARCH)
    params = stack_trees([
        {k: torch.tensor(np.asarray(v)) for k, v in
         params_to_state_dict(v).items()} for v in variables])
    g = vmap(grad(_member_loss(model)), in_dims=(0, None, None))(
        params, *_t((x, gt)))
    for i in range(len(SEEDS)):
        ref = params_to_state_dict({"params": jarray.unstack_tree(jg, i)})
        for k, r in ref.items():
            np.testing.assert_allclose(g[k][i].numpy(), r, rtol=1e-4,
                                       atol=1e-4 * np.abs(r).max(),
                                       err_msg=(i, k))


def test_tensor_threshold_decodes_as_jax_traced_threshold():
    """Repair: ``if not threshold`` could not take a tensor. A batched
    threshold under ``vmap`` is a fixed threshold (0 too), as JAX's traced
    one; Python None, 0 and 0.0 keep the per-row maximum."""
    rng = np.random.default_rng(5)
    heat = rng.standard_normal((3, 1, 400)).astype(np.float32)
    gs = rng.uniform(10, 90, (3, 2)).astype(np.float32)
    ths = np.asarray([0.0, 0.1, 0.7], np.float32)

    def decode(th):
        es = peaks.mask2coords(torch.from_numpy(heat), 20, th, 4, 8)
        return es, toa_rmse(torch.from_numpy(gs), es, tol=4.0)

    def jdecode(th):
        es = jpeaks.mask2coords(jnp.asarray(heat), 20, th, 4, 8)
        return es, jmetrics.toa_rmse(jnp.asarray(gs), es, tol=4.0)

    es, met = vmap(decode)(torch.from_numpy(ths))
    jes, jmet = jax.vmap(jdecode)(jnp.asarray(ths))
    np.testing.assert_array_equal(es.numpy(), np.asarray(jes))
    np.testing.assert_allclose(met.numpy(), np.asarray(jmet), rtol=1e-5,
                               equal_nan=True)
    for t, th in enumerate(ths[1:], start=1):
        np.testing.assert_array_equal(es[t].numpy(),
                                      decode(float(th))[0].numpy())
    scores = torch.from_numpy(heat[:, 0])
    row_max = peaks.threshold_scores(scores, None)
    for falsy in (0, 0.0):
        assert torch.equal(peaks.threshold_scores(scores, falsy), row_max)
    np.testing.assert_array_equal(row_max.numpy(), np.asarray(
        jpeaks.threshold_scores(jnp.asarray(heat[:, 0]), None)))
    assert int((row_max != 0).sum()) == 3
    assert (peaks.threshold_scores(scores, torch.tensor(0.0)) != 0).sum() > 3


# --- Part 1: the array ------------------------------------------------------


@pytest.fixture(scope="module")
def trained():
    """Two array steps over SEEDS and each seed's solo run."""
    batches = [_t(_batch(seed)) for seed in (7, 8)]
    state, _, losses = _array_run(_build, SEEDS, batches)
    solo = [_solo_run(_build, s, batches) for s in SEEDS]
    return state, losses, solo, batches


def test_multi_seed_array_matches_solo_runs(trained):
    state, losses, solo, _ = trained
    assert n_members(state.params) == len(SEEDS)
    for i, (model, solo_losses, _) in enumerate(solo):
        np.testing.assert_allclose(losses[:, i], solo_losses, rtol=1e-5)
        _assert_member(state, i, model)
    assert len(np.unique(losses[0])) == len(SEEDS)
    w = state.params["conv1.weight"]
    assert (w[0] - w[1]).abs().max() > 1e-3


@pytest.mark.parametrize("kw", [dict(remat=True), dict(accum=2),
                                dict(amp=True), dict(remat=True, accum=2)],
                         ids=["remat", "accum2", "amp", "remat_accum2"])
def test_array_options_match_solo_steps(kw):
    batches = [_t(_batch(seed)) for seed in (7, 8)]
    state, _, losses = _array_run(_build, SEEDS[:2], batches, **kw)
    for i, seed in enumerate(SEEDS[:2]):
        model, solo_losses, _ = _solo_run(_build, seed, batches, **kw)
        np.testing.assert_allclose(losses[:, i], solo_losses, rtol=1e-5)
        _assert_member(state, i, model)


def test_lr_scales_match_solo_runs_at_scaled_lr():
    """Same-init members at lr * s: each equals a solo run at that rate
    (AdamW's whole update scaled, decay included)."""
    batches = [_t(_batch(seed)) for seed in (7, 8)]
    scales = [1.0, 3.0]
    state, opt, losses = _array_run(_build, [0, 0], batches,
                                    lr_scales=scales)
    assert losses[1, 0] != losses[1, 1]
    for i, s in enumerate(scales):
        model, solo_losses, _ = _solo_run(_build, 0, batches, lr=LR * s)
        np.testing.assert_allclose(losses[:, i], solo_losses, rtol=1e-5)
        _assert_member(state, i, model)
        sd = member_optimizer_state(opt, i, s)
        assert sd["param_groups"][0]["lr"] == pytest.approx(LR * s)
    with pytest.raises(ValueError, match="lr_scales"):
        _array_run(_build, [0, 0], batches, lr_scales=[1.0])


ZOO = dict(dataset_kind="chirp", upsample_factor=4, sample_num=200,
           rf_scale_factor=4, fs=1e6)


@functools.lru_cache(maxsize=None)
def _zoo_state(name, seed):
    return build_model(name, device="cpu", **ZOO,
                       generator=torch.Generator().manual_seed(seed)
                       )[0].state_dict()


def _zoo(name, b=4):
    """(build, loss config, batch) of a zoo family: ``build(g)`` is the
    model ``build_model`` draws from ``g``'s seed (drawn once a seed)."""
    def build(g):
        model = build_model(name, device="meta", **ZOO)[0]
        state = _zoo_state(name, g.initial_seed())
        model.load_state_dict({k: v.clone() for k, v in state.items()},
                              assign=True)
        return model

    up = 1 if name in ("sincnet", "unet") else 4
    x, gs, gt = _batch(11, b, ZOO["sample_num"] * ZOO["rf_scale_factor"])
    gt = np.round(gs[:, None, :] * up).astype(np.int32)
    return build, dict(upsample_factor=up, max_echoes=8), _t((x, gs, gt))


@pytest.mark.parametrize("name", ["unet", "sincnet"])
def test_batchnorm_members_keep_their_own_statistics(name):
    build, cfg, batch = _zoo(name)
    state, _, losses = _array_run(build, [0, 1], [batch], cfg=cfg)
    grads = {k: v.grad for k, v in state.params.items()}
    stats = [k for k in state.buffers
             if k.endswith(("running_mean", "running_var"))]
    for i in range(2):
        model, solo_losses, solo_grads = _solo_run(build, i, [batch],
                                                   cfg=cfg)
        np.testing.assert_allclose(losses[:, i], solo_losses, rtol=1e-5)
        for k in stats:
            np.testing.assert_allclose(state.buffers[k][i].numpy(),
                                       model.state_dict()[k].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        # atol of the model's largest gradient: a conv bias that a
        # train-mode BatchNorm follows has a gradient of float noise
        top = max(float(r.abs().max()) for r in solo_grads.values())
        for k, r in solo_grads.items():
            np.testing.assert_allclose(grads[k][i].numpy(), r.numpy(),
                                       rtol=1e-4, atol=1e-4 * top,
                                       err_msg=k)
    assert max(float((state.buffers[k][0] - state.buffers[k][1]).abs()
                     .max()) for k in stats) > 1e-6


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_kuleshov_dropout_masks_are_each_members_solo_masks(remat):
    """Member i's masks come from ``dropout_seed(seed_i, step, micro)``,
    drawn ahead and taken into the vmapped loss: its losses over two steps
    (the second step at another count, other masks) are its solo run's;
    under remat the recomputed forward takes the same masks."""
    build, cfg, batch = _zoo("kuleshov", b=2)
    batches = [batch] * (1 if remat else 2)
    _, _, losses = _array_run(build, [0, 1], batches, cfg=cfg, remat=remat)
    for i in range(2):
        _, solo_losses, _ = _solo_run(build, i, batches, cfg=cfg,
                                      remat=remat)
        np.testing.assert_allclose(losses[:, i], solo_losses, rtol=1e-5)
    assert losses[0, 0] != losses[0, 1]


def test_per_member_data_feeds_each_member_its_slice():
    (x0, gs0, gt0), (x1, gs1, gt1) = _batch(7), _batch(8)
    data = _t((np.stack([x0, x1]), np.stack([gs0, gs1]),
               np.stack([gt0, gt1])))
    state, _, losses = _array_run(_build, [0, 1], [data],
                                  per_member_data=True, accum=2)
    for i, b in enumerate([_t(_batch(7)), _t(_batch(8))]):
        model, solo_losses, _ = _solo_run(_build, i, [b], accum=2)
        np.testing.assert_allclose(losses[:, i], solo_losses, rtol=1e-5)
        _assert_member(state, i, model)


def test_duplicate_seeds_are_refused_unless_allowed():
    with pytest.raises(ValueError, match="duplicate seeds"):
        init_array_state(_build, [3, 3])
    state = init_array_state(_build, [3, 3], allow_duplicate_seeds=True)
    assert n_members(state.buffers | state.params) == 2


def test_array_eval_matches_solo_eval(trained):
    state, _, solo, batches = trained
    for th in (None, 0.05):
        cfg = LossConfig(th=th, etol=100.0, **CFG)
        out = make_array_eval_step(state.model, cfg)(state.variables(),
                                                     *batches[0])
        assert "masks_pred" not in out
        assert out["toa_metrics"].shape == (len(SEEDS), 4, 7)
        for i, (model, _, _) in enumerate(solo):
            ref = make_eval_step(model, cfg)(*batches[0])
            np.testing.assert_allclose(out["es_sample"][i].numpy(),
                                       ref["es_sample"].numpy(),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(float(out["loss"][i]),
                                       float(ref["loss"]), rtol=1e-4)
    kept = make_array_eval_step(state.model, LossConfig(**CFG),
                                keep_heatmaps=True)(state.variables(),
                                                    *batches[0])
    assert kept["masks_pred"].shape == (len(SEEDS), 4, 1, LENGTH * 4)


def test_threshold_sweep_matches_per_threshold_decode(trained):
    state, _, solo, batches = trained
    model = solo[0][0]
    ths = [0.02, 0.05, 0.2]
    sweep = make_threshold_sweep_step(state.model, LossConfig(**CFG))
    out = sweep(state.member(0), *batches[0], torch.tensor(ths))
    assert out["toa_metrics"].shape == (len(ths), 4, 7)
    for t, th in enumerate(ths):
        ref = make_eval_step(model, LossConfig(th=th, **CFG))(*batches[0])
        np.testing.assert_array_equal(out["es_sample"][t].numpy(),
                                      ref["es_sample"].numpy())
        np.testing.assert_allclose(out["toa_metrics"][t].numpy(),
                                   ref["toa_metrics"].numpy(), rtol=1e-5,
                                   atol=1e-5, equal_nan=True)


def test_stack_checkpoint_variables_shape_guard_and_round_trip():
    a, b = (_build(torch.Generator().manual_seed(s)).state_dict()
            for s in (0, 1))
    narrow = StofNet(num_features=8, num_blocks=3, device="cpu").state_dict()
    stacked = stack_checkpoint_variables([a, b])
    assert n_members(stacked) == 2
    for i, sd in enumerate((a, b)):
        for k, v in unstack_tree(stacked, i).items():
            assert torch.equal(v, sd[k]), k
    with pytest.raises(ValueError, match="different architecture"):
        stack_checkpoint_variables([a, narrow])
    with pytest.raises(ValueError):
        stack_trees([])


# --- against JAX's array ----------------------------------------------------


@pytest.fixture(scope="module")
def jax_members():
    """JAX's stacked init of SEEDS, two array steps of it (with and
    without lr_scales), its eval and sweep outputs; and the members' state
    dicts."""
    jmodel = JaxStofNet(**ARCH)
    tx, _ = jsteps.make_optimizer(lr=LR, steps_per_epoch=100)
    jcfg = jsteps.LossConfig(**CFG)
    x0 = jnp.zeros((1, 1, LENGTH))
    init = jarray.init_array_state(jmodel, tx, SEEDS, x0)
    states = [{k: torch.tensor(np.asarray(v)) for k, v in params_to_state_dict(
        {"params": jarray.unstack_tree(init.params, i)}).items()}
        for i in range(len(SEEDS))]
    batches = [_batch(seed) for seed in (7, 8)]
    out = {}
    for key, scales in (("plain", None), ("lr", [0.5, 1.0, 2.0])):
        step = jarray.make_array_train_step(jmodel, tx, jcfg,
                                            lr_scales=scales)
        st, losses = init, []
        for b in batches:
            st, aux = step(st, *map(jnp.asarray, b))
            losses.append(np.asarray(aux["loss"]))
        out[key] = np.stack(losses)
    x, gs, gt = map(jnp.asarray, batches[0])
    ev = jsteps.LossConfig(th=None, etol=100.0, **CFG)
    out["eval"] = jarray.make_array_eval_step(jmodel, ev)(
        {"params": init.params}, x, gs, gt)
    out["sweep"] = jarray.make_threshold_sweep_step(jmodel, ev)(
        {"params": jarray.unstack_tree(init.params, 0)}, x, gs, gt,
        jnp.asarray([0.02, 0.05, 0.2]))
    return states, batches, out


def _from(states):
    it = iter(states)

    def build(g):
        model = StofNet(device="cpu", **ARCH)
        model.load_state_dict(next(it))
        return model
    return build


@pytest.mark.parametrize("key", ["plain", "lr"])
def test_array_train_matches_jax_array(jax_members, key):
    states, batches, ref = jax_members
    scales = [0.5, 1.0, 2.0] if key == "lr" else None
    _, _, losses = _array_run(_from(states), SEEDS, map(_t, batches),
                              lr_scales=scales)
    np.testing.assert_allclose(losses, ref[key], rtol=1e-4)


def test_array_eval_and_sweep_match_jax(jax_members):
    states, batches, ref = jax_members
    cfg = LossConfig(th=None, etol=100.0, **CFG)
    model = StofNet(device="meta", **ARCH)
    batch = _t(batches[0])
    out = make_array_eval_step(model, cfg)(stack_trees(states), *batch)
    np.testing.assert_allclose(out["es_sample"].numpy(),
                               np.asarray(ref["eval"]["es_sample"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out["loss"].numpy(),
                               np.asarray(ref["eval"]["loss"]), rtol=1e-4)
    sweep = make_threshold_sweep_step(model, cfg)(
        states[0], *batch, torch.tensor([0.02, 0.05, 0.2]))
    np.testing.assert_array_equal(sweep["es_sample"].numpy(),
                                  np.asarray(ref["sweep"]["es_sample"]))
    np.testing.assert_allclose(sweep["toa_metrics"].numpy(),
                               np.asarray(ref["sweep"]["toa_metrics"]),
                               rtol=1e-5, atol=1e-5, equal_nan=True)
