"""The port's training path (stofnet_tpu_torch.train and ops/gaussian.py)
against the JAX package's, on the CPU: Gaussian kernel and blur, the
heatmap and regression losses, ``toa_rmse``, the AdamW update and its
schedule, the module and fused train steps over two steps, the eval step,
gradient accumulation, checkpoint resume and early stopping.

Adam's first update is about lr * sign(g) for every element, so an element
whose gradient is float noise can move 2 lr further in one framework than
in the other, and the second step's gradients then differ a little
everywhere. An element counts as noise when, at either step, its gradient
is below 1e-4 of its leaf's largest, or the two frameworks' gradients
differ in sign or by more than 1 %. The parameter comparisons after two
steps hold such elements to 4 lr and every other element to atol 1e-5 in
f32 and lr / 10 in bf16 (an optimizer that did nothing would sit about
2 lr away); the f32 first step's gradients are held to rtol 1e-4
everywhere.
"""

import numpy as np
import optax
import pytest
import jax
import jax.numpy as jnp
import torch

from stofnet_tpu.models import StofNet as JaxStofNet
from stofnet_tpu.models.fused import stofnet_apply_fused as jax_fused
from stofnet_tpu.ops import gaussian as jgauss
from stofnet_tpu.ops import peaks as jpeaks
from stofnet_tpu.train import early_stop as jearly
from stofnet_tpu.train import loss as jloss
from stofnet_tpu.train import metrics as jmetrics
from stofnet_tpu.train import steps as jsteps
from stofnet_tpu_torch.models import StofNet, build_model
from stofnet_tpu_torch.models.torch_import import params_to_state_dict
from stofnet_tpu_torch.ops import gaussian, peaks
from stofnet_tpu_torch.train import (
    EarlyStopping, LossConfig, find_checkpoint, first_valid_toa,
    heatmap_loss, load_checkpoint, load_model_variables, make_eval_step,
    make_fused_train_step, make_optimizer, make_train_step, regression_loss,
    resume_optimizer, save_checkpoint, toa_rmse,
)

LR = 5e-4
CFG = dict(upsample_factor=4, max_echoes=8)


@pytest.mark.parametrize("size,sigma", [(7, 1.0), (4, 1.0), (1, 1.0),
                                        (9, 2.5)])
def test_gaussian_kernel_matches_jax(size, sigma):
    """Even sizes take numpy's floor division: -4 // 2 + 1 = -1."""
    got = gaussian.gaussian_kernel(size, sigma).numpy()
    ref = np.asarray(jgauss.gaussian_kernel(size, sigma))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("size", [7, 4])
def test_gaussian_blur1d_matches_jax(rng, size):
    x = rng.standard_normal((3, 2, 50)).astype(np.float32)
    k = np.asarray(jgauss.gaussian_kernel(size, 1.5))
    got = gaussian.gaussian_blur1d(torch.from_numpy(x),
                                   torch.tensor(k)).numpy()
    ref = np.asarray(jgauss.gaussian_blur1d(jnp.asarray(x), jnp.asarray(k)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def _gt_true(rng, batch, k, length):
    """(B, 1, K) int GT positions: valid, 0 (invalid), negative (clamped
    to the invalid slot) and >= length (dropped)."""
    gt = rng.integers(1, length, (batch, 1, k)).astype(np.int32)
    gt[0, 0, -1] = 0
    gt[1, 0, -1] = -5
    gt[1, 0, 0] = length + 3
    return gt


def test_coords2mask_matches_jax_on_training_shapes(rng):
    gt = _gt_true(rng, 4, 3, 400)
    got = peaks.coords2mask(torch.from_numpy(gt), 400).numpy()
    ref = np.asarray(jpeaks.coords2mask(jnp.asarray(gt), 400))
    assert got.shape == (4, 1, 400)
    np.testing.assert_array_equal(got, ref)
    assert not got[..., 0].any()


@pytest.mark.parametrize("with_norm_max", [False, True])
def test_heatmap_loss_matches_jax(rng, with_norm_max):
    pred = rng.standard_normal((4, 1, 400)).astype(np.float32)
    gt = _gt_true(rng, 4, 3, 400)
    norm = 0.37 if with_norm_max else None
    got, mask = heatmap_loss(torch.from_numpy(pred), torch.from_numpy(gt),
                             norm_max=None if norm is None
                             else torch.tensor(norm))
    ref, ref_mask = jloss.heatmap_loss(jnp.asarray(pred), jnp.asarray(gt),
                                       norm_max=None if norm is None
                                       else jnp.asarray(norm))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))


def test_regression_loss_matches_jax(rng):
    gt_sample = rng.uniform(1, 100, (5, 3)).astype(np.float32)
    gt_true = rng.integers(0, 4, (5, 3)).astype(np.int32)
    gt_true[0] = 0  # no valid slot: argmin of all-1e12 picks slot 0
    pred = rng.uniform(1, 100, (5, 1)).astype(np.float32)
    got, target = regression_loss(*map(torch.from_numpy,
                                       (pred, gt_sample, gt_true)))
    ref, ref_target = jloss.regression_loss(*map(jnp.asarray,
                                                 (pred, gt_sample, gt_true)))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    np.testing.assert_array_equal(target.numpy(), np.asarray(ref_target))
    np.testing.assert_array_equal(
        first_valid_toa(torch.from_numpy(gt_sample),
                        torch.from_numpy(gt_true)).numpy(),
        np.asarray(jloss.first_valid_toa(jnp.asarray(gt_sample),
                                         jnp.asarray(gt_true))))


def test_toa_rmse_matches_jax():
    """Rows: matched; no valid estimate; no valid GT; NaN and Inf slots;
    valid on both sides but nothing within tolerance (mes NaN); a 1-D
    input pair."""
    nan, inf = np.nan, np.inf
    gt = np.array([[10, 20, 0], [10, 0, 0], [0, 0, 0], [nan, 30, inf],
                   [10, 50, 0]], np.float32)
    es = np.array([[10.5, 19, 40], [0, 0, 0], [5, 6, 7], [30.2, nan, 0],
                   [100, 200, 0]], np.float32)
    for tol in (1.0, 4.0):
        got = toa_rmse(torch.from_numpy(gt), torch.from_numpy(es), tol)
        ref = jmetrics.toa_rmse(jnp.asarray(gt), jnp.asarray(es), tol)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   equal_nan=True)
    assert np.isnan(got[1, 1].item()) and np.isnan(got[4, 0].item())
    got = toa_rmse(torch.tensor([3.0, 0.0]), torch.tensor([3.5, 1.0]))
    ref = jmetrics.toa_rmse(jnp.asarray([3.0, 0.0]), jnp.asarray([3.5, 1.0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               equal_nan=True)


def test_optimizer_schedule_matches_optax():
    """The learning rate of updates 0, 99, 100 and 8000: constant within an
    epoch of 100 steps, at rest after 80 epochs."""
    p = torch.zeros(1, requires_grad=True)
    opt, sched = make_optimizer([p], lr=LR, epochs=80, steps_per_epoch=100)
    _, schedule = jsteps.make_optimizer(lr=LR, epochs=80, steps_per_epoch=100)
    seen = {}
    for step in range(8001):
        if step in (0, 99, 100, 8000):
            seen[step] = opt.param_groups[0]["lr"]
        p.grad = torch.zeros(1)
        opt.step()
        sched.step()
    for step, lr in seen.items():
        np.testing.assert_allclose(lr, float(schedule(step)), rtol=1e-6)
    assert seen[0] == seen[99] > seen[100] and seen[8000] == 0.0


def test_adamw_update_matches_optax(rng):
    """Three AdamW updates of a vector under changing gradients, with a
    weight decay large enough to see (where eps sits, the decoupled decay
    on the pre-step parameter, the schedule). Updates of about lr = 0.1
    round to f32 at other points in each: atol 5e-6 after three."""
    p0 = rng.standard_normal(64).astype(np.float32)
    grads = [rng.standard_normal(64).astype(np.float32) * s
             for s in (1.0, 1e-3, 10.0)]
    p = torch.tensor(p0, requires_grad=True)
    opt, sched = make_optimizer([p], lr=0.1, weight_decay=0.3, epochs=4,
                                steps_per_epoch=1)
    tx, _ = jsteps.make_optimizer(lr=0.1, weight_decay=0.3, epochs=4,
                                  steps_per_epoch=1)
    pj = jnp.asarray(p0)
    state = tx.init(pj)
    for g in grads:
        p.grad = torch.from_numpy(g)
        opt.step()
        sched.step()
        updates, state = tx.update(jnp.asarray(g), state, pj)
        pj = optax.apply_updates(pj, updates)
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(pj),
                               rtol=1e-5, atol=5e-6)


def _init(length, seed=0):
    variables = JaxStofNet().init(jax.random.key(seed),
                                  jnp.zeros((1, 1, length)))
    state = {k: torch.tensor(v)
             for k, v in params_to_state_dict(variables).items()}
    return variables, state


def _batch(rng, batch=2, length=800):
    x = rng.standard_normal((batch, 1, length)).astype(np.float32)
    x /= np.abs(x).max(-1, keepdims=True)
    gt_sample = np.stack([rng.uniform(50, length - 50, batch)
                          for _ in range(2)], -1).astype(np.float32)
    gt_true = np.round(gt_sample[:, None, :] * 4).astype(np.int32)
    return x, gt_sample, gt_true


def _assert_params_close(got, ref, grads_got, grads_ref, atol):
    """Parameters after two steps, from the gradients of each step in each
    framework (module docstring: elements whose gradient is float noise at
    either step may move 4 lr apart)."""
    for k in ref:
        noise = np.zeros(ref[k].shape, bool)
        for g_got, g_ref in zip(grads_got, grads_ref):
            g, r = g_got[k], g_ref[k]
            noise |= ((np.abs(r) <= 1e-4 * np.abs(r).max())
                      | (np.sign(g) != np.sign(r))
                      | (np.abs(g - r) > 1e-2 * np.abs(r)))
        d = np.abs(got[k] - ref[k])
        assert d[~noise].max(initial=0) <= atol, (k, d[~noise].max())
        assert d.max() <= 4 * LR + atol, (k, d.max())


def _assert_bf16_run_close(got, ref):
    """Two bf16 steps, port against JAX, each a (losses, gradients,
    params) triple: losses to rtol 1e-4 and 5e-4, the first step's
    gradients to 5e-2 relative L2 per leaf, the parameters after two steps
    to lr / 10 off the noise elements."""
    np.testing.assert_allclose(got[0][0], ref[0][0], rtol=1e-4)
    np.testing.assert_allclose(got[0][1], ref[0][1], rtol=5e-4)
    for k, r in ref[1][0].items():
        rel = np.linalg.norm(got[1][0][k] - r) / np.linalg.norm(r)
        assert rel <= 5e-2, (k, rel)
    _assert_params_close(got[2], ref[2], got[1], ref[1], atol=LR / 10)


def _jax_module_run(variables, batches, amp):
    """Two JAX train steps; (losses, gradients before each step, params)."""
    model = JaxStofNet()
    cfg = jsteps.LossConfig(**CFG)
    tx, _ = jsteps.make_optimizer(lr=LR, steps_per_epoch=100)
    step = jsteps.make_train_step(model, tx, cfg, amp=amp)
    state = jsteps.init_train_state(variables, tx)
    kernel = jgauss.gaussian_kernel(cfg.kernel_size, cfg.sigma)

    def loss_fn(params, x, gt_true):
        if amp:
            params = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
            x = x.astype(jnp.bfloat16)
        pred = model.apply({"params": params}, x).astype(jnp.float32)
        return jloss.heatmap_loss(pred, gt_true, kernel=kernel)[0]

    losses, grads = [], []
    for x, gs, gt in batches:
        grads.append(params_to_state_dict({"params": jax.grad(loss_fn)(
            state.params, jnp.asarray(x), jnp.asarray(gt))}))
        state, aux = step(state, jnp.asarray(x), jnp.asarray(gs),
                          jnp.asarray(gt))
        losses.append(float(aux["loss"]))
    return losses, grads, params_to_state_dict({"params": state.params})


def _port_module_run(state, batches, amp, **kw):
    """Two port train steps; (losses, gradients of each step, params)."""
    model = StofNet(device="cpu")
    model.load_state_dict(state)
    opt, sched = make_optimizer(model.parameters(), lr=LR,
                                steps_per_epoch=100)
    step = make_train_step(model, opt, sched, LossConfig(**CFG), amp=amp,
                           **kw)
    losses, grads = [], []
    for x, gs, gt in batches:
        losses.append(step(*map(torch.from_numpy, (x, gs, gt)))["loss"].item())
        grads.append({k: p.grad.numpy().copy()
                      for k, p in model.named_parameters()})
    return losses, grads, {k: v.detach().numpy()
                           for k, v in model.state_dict().items()}


def test_module_train_step_matches_jax_f32(rng):
    variables, state = _init(800)
    batches = [_batch(rng) for _ in range(2)]
    ref = _jax_module_run(variables, batches, amp=False)
    got = _port_module_run(state, batches, amp=False)
    np.testing.assert_allclose(got[0][0], ref[0][0], rtol=1e-4)
    for k, r in ref[1][0].items():
        np.testing.assert_allclose(got[1][0][k], r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max(), err_msg=k)
    np.testing.assert_allclose(got[0][1], ref[0][1], rtol=1e-3)
    _assert_params_close(got[2], ref[2], got[1], ref[1], atol=1e-5)


def test_module_train_step_matches_jax_amp(rng):
    """bf16 forward with f32 masters: both frameworks round bf16 after
    each conv and bias add, and the port's bf16 convs sum in another order.
    At this size JAX's step in bf16 and in f32 differ by 1.1e-4 in the
    first loss, 1.4e-3 in the second and 4.4e-3 to 4.1e-2 relative L2 per
    gradient leaf; the port against JAX in bf16 read 1.0e-6, 1.3e-4 and at
    most 1.65e-2. So the second loss, held to 5e-4, tells bf16 from f32;
    the gradients are held to 5e-2 per leaf, which does not; the
    parameters as in the f32 test, the non-noise elements to lr / 10."""
    variables, state = _init(800)
    batches = [_batch(rng) for _ in range(2)]
    ref = _jax_module_run(variables, batches, amp=True)
    got = _port_module_run(state, batches, amp=True)
    _assert_bf16_run_close(got, ref)


def test_remat_and_accum_equal_the_plain_step(rng):
    """accum=2 splits the batch of 4 into two micro-batches with the full
    batch's blur normalizer: the same loss and gradients as one pass;
    remat recomputes the forward and changes nothing."""
    _, state = _init(800)
    batches = [_batch(rng, batch=4)]
    base = _port_module_run(state, batches, amp=False)
    for kw in (dict(accum=2), dict(remat=True)):
        got = _port_module_run(state, batches, amp=False, **kw)
        np.testing.assert_allclose(got[0], base[0], rtol=1e-5)
        for k, r in base[1][0].items():
            np.testing.assert_allclose(got[1][0][k], r, rtol=1e-4,
                                       atol=1e-5 * np.abs(r).max(),
                                       err_msg=(k, kw))
    with pytest.raises(ValueError, match="accum"):
        _port_module_run(state, [_batch(rng, batch=3)], amp=False, accum=2)


def test_update_scale_is_a_learning_rate_factor(rng):
    """update_scale s equals running that step at lr * s (decay included);
    the schedule is untouched for the next step."""
    _, state = _init(800)
    x, gs, gt = map(torch.from_numpy, _batch(rng))
    runs = []
    for lr, scale in ((LR, 0.5), (LR / 2, None)):
        model = StofNet(device="cpu")
        model.load_state_dict(state)
        opt, sched = make_optimizer(model.parameters(), lr=lr,
                                    weight_decay=0.1, steps_per_epoch=100)
        make_train_step(model, opt, sched, LossConfig(**CFG))(
            x, gs, gt, update_scale=scale)
        runs.append((model.state_dict(), opt.param_groups[0]["lr"]))
    for k, v in runs[0][0].items():
        torch.testing.assert_close(v, runs[1][0][k], rtol=0, atol=1e-7)
    assert runs[0][1] == LR


def _fused_runs(rng, dtype):
    """Two fused train steps in each framework, bench.py's fused_step
    recipe (heatmap_loss of the trainable fused forward, one AdamW update)
    on the same weights and batches."""
    variables, state = _init(800)
    batches = [_batch(rng) for _ in range(2)]
    cfg = jsteps.LossConfig(**CFG)
    tx, _ = jsteps.make_optimizer(lr=LR, steps_per_epoch=100)
    kernel = jgauss.gaussian_kernel(cfg.kernel_size, cfg.sigma)
    jdt = None if dtype is None else jnp.bfloat16

    def loss_fn(params, frame, gt_true):
        pred = jax_fused({"params": params}, frame, dtype=jdt,
                         interpret=True, trainable=True)
        return jloss.heatmap_loss(pred, gt_true, kernel=kernel)[0]

    @jax.jit
    def fused_step(params, opt_state, frame, gt_true):
        loss, grads = jax.value_and_grad(loss_fn)(params, frame, gt_true)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    params, opt_state = variables["params"], tx.init(variables["params"])
    ref_losses, ref_grads = [], []
    for x, _, gt in batches:
        params, opt_state, loss, grads = fused_step(
            params, opt_state, jnp.asarray(x), jnp.asarray(gt))
        ref_losses.append(float(loss))
        ref_grads.append(params_to_state_dict({"params": grads}))
    ref_params = params_to_state_dict({"params": params})

    tparams = {k: torch.nn.Parameter(v) for k, v in state.items()}
    opt, sched = make_optimizer(tparams.values(), lr=LR, steps_per_epoch=100)
    step = make_fused_train_step(tparams, opt, sched, LossConfig(**CFG),
                                 dtype=dtype)
    losses, grads = [], []
    for x, _, gt in batches:
        losses.append(step(torch.from_numpy(x), torch.from_numpy(gt)).item())
        grads.append({k: p.grad.numpy().copy() for k, p in tparams.items()})
    got_params = {k: p.detach().numpy() for k, p in tparams.items()}
    return (losses, grads, got_params), (ref_losses, ref_grads, ref_params)


def test_fused_train_step_matches_jax_f32(rng):
    got, ref = _fused_runs(rng, None)
    np.testing.assert_allclose(got[0][0], ref[0][0], rtol=1e-4)
    for k, r in ref[1][0].items():
        np.testing.assert_allclose(got[1][0][k], r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max(), err_msg=k)
    np.testing.assert_allclose(got[0][1], ref[0][1], rtol=1e-3)
    _assert_params_close(got[2], ref[2], got[1], ref[1], atol=1e-5)


def test_fused_train_step_matches_jax_bf16(rng):
    """The bf16 fused step: the same rounding points in both frameworks,
    bf16 convs summed in another order, and near-tie window maxima that
    the order may flip. At this size JAX's fused step in bf16 and in f32
    differ by 1.1e-4 in the first loss, 1.8e-3 in the second and 4.6e-3
    to 3.3e-2 relative L2 per gradient leaf; the port against JAX in bf16
    read 3.2e-5, 1.4e-4 and at most 1.5e-2. Held as the amp test."""
    got, ref = _fused_runs(rng, torch.bfloat16)
    _assert_bf16_run_close(got, ref)


def test_eval_step_matches_jax(rng):
    variables, state = _init(800)
    x, gs, gt = _batch(rng)
    ref = jsteps.make_eval_step(JaxStofNet(), jsteps.LossConfig(**CFG))(
        variables, jnp.asarray(x), jnp.asarray(gs), jnp.asarray(gt))
    model = StofNet(device="cpu")
    model.load_state_dict(state)
    got = make_eval_step(model, LossConfig(**CFG))(
        *map(torch.from_numpy, (x, gs, gt)))
    np.testing.assert_allclose(got["loss"].item(), float(ref["loss"]),
                               rtol=1e-4)
    np.testing.assert_array_equal(got["es_sample"].numpy(),
                                  np.asarray(ref["es_sample"]))
    np.testing.assert_allclose(got["toa_metrics"].numpy(),
                               np.asarray(ref["toa_metrics"]), rtol=1e-5,
                               equal_nan=True)


def test_checkpoint_resume_is_bit_identical(rng, tmp_path):
    """Two steps, save, two more; against a fresh model, optimizer and
    schedule restored from the checkpoint taking the same two steps."""
    _, state = _init(800)
    batches = [tuple(map(torch.from_numpy, _batch(rng))) for _ in range(4)]

    def make():
        model = StofNet(device="cpu")
        model.load_state_dict(state)
        opt, sched = make_optimizer(model.parameters(), lr=LR,
                                    steps_per_epoch=1, epochs=3)
        return model, opt, sched, make_train_step(model, opt, sched,
                                                  LossConfig(**CFG))

    model, opt, sched, step = make()
    for b in batches[:2]:
        step(*b)
    path = save_checkpoint(tmp_path / "ckpt.pt", model.state_dict(), opt,
                           sched, step=2)
    for b in batches[2:]:
        step(*b)

    model2, opt2, sched2, step2 = make()
    ckpt = load_checkpoint(path, model2.state_dict(), opt2, sched2)
    assert ckpt["step"] == 2
    assert opt2.param_groups[0]["lr"] < LR  # the schedule resumed at step 2
    for b in batches[2:]:
        step2(*b)
    for k, v in model.state_dict().items():
        assert torch.equal(v, model2.state_dict()[k]), k
    assert opt.param_groups[0]["lr"] == opt2.param_groups[0]["lr"]


def test_model_files_and_lookup(tmp_path):
    _, state = _init(80)
    torch.save(state, tmp_path / "different-armadillo-1439_ep46.pth")
    save_checkpoint(tmp_path / "run_seed3009.pt", state)
    found = find_checkpoint(tmp_path, "different-armadillo")
    assert found.name.startswith("different-armadillo")
    assert find_checkpoint(tmp_path, "run_seed3009").name == "run_seed3009.pt"
    assert find_checkpoint(tmp_path / "missing", "x") is None
    for path in (found, tmp_path / "run_seed3009.pt"):
        loaded = load_model_variables("stofnet", path)
        assert loaded.keys() == state.keys()
        for k in state:
            assert torch.equal(loaded[k], state[k])
    # a reference .pth of a zoo family loads through the registry, under
    # the module's names
    edsr, _ = build_model("edsr", device="cpu",
                          generator=torch.Generator().manual_seed(0))
    torch.save(edsr.state_dict(), tmp_path / "proud-cherry_ep9.pth")
    loaded = load_model_variables(
        "edsr", find_checkpoint(tmp_path, "proud-cherry"))
    edsr.load_state_dict(loaded, strict=True)
    for k, v in edsr.state_dict().items():
        assert torch.equal(loaded[k], v), k


def test_early_stopping_matches_jax():
    losses = [1.0, 0.9, 0.95, 0.91, 0.92, 0.8, 0.85, 0.86, 0.87]
    got = EarlyStopping(patience=3, delta=0.01, verbose=None)
    ref = jearly.EarlyStopping(patience=3, delta=0.01, verbose=None)
    for v in losses:
        assert got(v) == ref(v)
        assert (got.counter, got.best_score) == (ref.counter, ref.best_score)
    assert got.early_stop


def _conv_weights(model):
    return {k: p for k, p in model.named_parameters()
            if k.endswith(".weight")}


@pytest.mark.parametrize("case", ["accum1", "accum2", "remat", "remat_accum2",
                                  "eval"])
def test_f32_module_steps_compute_without_tf32(rng, monkeypatch, case):
    """Repair: on the card PyTorch leaves cuDNN's TF32 on by default, so the
    f32 module steps' convs rounded their products to TF32 where JAX's f32
    step sums in full f32. cuDNN reads the flags when each conv launches,
    so the backward counts too. The caller sets both flags on; a spy on
    ``F.conv1d`` sees both off at every conv of the forward (and of remat's
    recomputed forward), a hook on each conv weight's gradient sees both
    off when the backward reaches that conv, for each micro-batch, and the
    caller's flags come back."""
    from stofnet_tpu_torch.ops import conv as conv_mod

    _, state = _init(800)
    model = StofNet(device="cpu")
    model.load_state_dict(state)
    forward_seen, backward_seen = [], []
    conv1d = conv_mod.F.conv1d

    def flags():
        return (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)

    def spy(*args, **kwargs):
        forward_seen.append(flags())
        return conv1d(*args, **kwargs)

    for p in _conv_weights(model).values():
        p.register_hook(lambda g: backward_seen.append(flags()))
    x, gs, gt = map(torch.from_numpy, _batch(rng, batch=4))
    accum = 2 if case.endswith("accum2") else 1
    if case == "eval":
        step = make_eval_step(model, LossConfig(**CFG))
    else:
        opt, sched = make_optimizer(model.parameters(), lr=LR)
        step = make_train_step(model, opt, sched, LossConfig(**CFG),
                               remat=case.startswith("remat"), accum=accum)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(conv_mod.F, "conv1d", spy)
    step(x, gs, gt)
    n_convs = len(_conv_weights(model))
    # forward convs: the model's, the loss's blur; remat runs them twice
    assert len(forward_seen) >= n_convs * accum
    assert set(forward_seen) == {(False, False)}
    if case == "eval":
        assert backward_seen == []
    else:
        assert len(backward_seen) == n_convs * accum
        assert set(backward_seen) == {(False, False)}
    assert flags() == (True, True)


def test_eval_step_halves_match_jax(rng):
    """``forward(frame) -> (pred, checksum)`` and ``finish(pred, gt_sample,
    gt_true)``, which the driver times apart, against the JAX step's
    halves; the whole step is their composition."""
    variables, state = _init(800)
    x, gs, gt = _batch(rng)
    ref = jsteps.make_eval_step(JaxStofNet(), jsteps.LossConfig(**CFG))
    pred_ref, sum_ref = ref.forward(variables, jnp.asarray(x))
    out_ref = ref.finish(pred_ref, jnp.asarray(gs), jnp.asarray(gt))
    model = StofNet(device="cpu")
    model.load_state_dict(state)
    step = make_eval_step(model, LossConfig(**CFG))
    pred, checksum = step.forward(torch.from_numpy(x))
    np.testing.assert_allclose(pred.numpy(), np.asarray(pred_ref),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(checksum.item(), float(sum_ref), rtol=1e-4)
    out = step.finish(pred, *map(torch.from_numpy, (gs, gt)))
    np.testing.assert_allclose(out["loss"].item(), float(out_ref["loss"]),
                               rtol=1e-4)
    np.testing.assert_array_equal(out["es_sample"].numpy(),
                                  np.asarray(out_ref["es_sample"]))
    whole = step(*map(torch.from_numpy, (x, gs, gt)))
    for k in ("loss", "es_sample", "toa_metrics", "masks_pred"):
        assert torch.equal(whole[k].nan_to_num(), out[k].nan_to_num()), k


def test_checkpoint_epoch_and_resume_under_another_schedule(rng, tmp_path):
    """``save_checkpoint`` stores the epoch; a file without one (written
    before it was stored, as the daemon's) loads with epoch 0.
    ``resume_optimizer`` takes the saved moments under this run's
    schedule: a run saved at the end of a 1-epoch cosine (its lr annealed
    to 0) resumes into a 2-epoch one at lr / 2, as JAX's count-based
    schedule gives."""
    _, state = _init(800)
    model = StofNet(device="cpu")
    model.load_state_dict(state)
    opt, sched = make_optimizer(model.parameters(), lr=LR, epochs=1,
                                steps_per_epoch=1)
    make_train_step(model, opt, sched, LossConfig(**CFG))(
        *map(torch.from_numpy, _batch(rng)))
    assert opt.param_groups[0]["lr"] == 0.0
    path = save_checkpoint(tmp_path / "ckpt", model.state_dict(), opt, sched,
                           step=1, epoch=1)
    old = tmp_path / "old"
    torch.save({k: v for k, v in torch.load(path, weights_only=True).items()
                if k != "epoch"}, old)
    assert load_checkpoint(old)["epoch"] == 0

    model2 = StofNet(device="cpu")
    opt2, sched2 = make_optimizer(model2.parameters(), lr=LR, epochs=2,
                                  steps_per_epoch=1)
    ckpt = load_checkpoint(path, model2.state_dict())
    assert ckpt["epoch"] == 1 and ckpt["step"] == 1
    resume_optimizer(opt2, sched2, ckpt["optimizer"], ckpt["step"])
    assert opt2.param_groups[0]["lr"] == pytest.approx(LR / 2, rel=1e-12)
    assert sched2.last_epoch == 1
    for p, p2 in zip(model.parameters(), model2.parameters()):
        assert torch.equal(p, p2)
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(opt.state[p][k], opt2.state[p2][k])
    sched2.step()
    assert opt2.param_groups[0]["lr"] == 0.0  # epoch 2 of 2
