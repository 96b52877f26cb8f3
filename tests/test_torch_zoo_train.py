"""Training the port's model zoo (``stofnet_tpu_torch/train/steps.py`` with
``model_kind``, flax-semantics BatchNorm, Kuleshov's dropout) against the
JAX package's steps, on the CPU.

Weights from each JAX module's ``init`` cross through
``registry.variables_to_state_dict``; frames and ToAs are made by numpy
from a seed, at a small B * L so that the biased running variance differs
from ``nn.BatchNorm1d``'s unbiased one by far more than the tolerance.
Tolerances:
- one train step's loss: rtol 1e-5, 1e-4 for the BatchNorm families and
  SincNet; its gradients: rtol 5e-3, atol 1e-3 * max|g| (the JAX zoo
  tests' own, ``tests/test_train_zoo.py``);
- BatchNorm running mean and var after one step: rtol 1e-5;
- amp (bf16): loss rtol 2e-3, statistics rtol 4e-3 (one bf16 spacing,
  2**-8, of the activations they average).
"""

import functools
import re

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stofnet_tpu.models import build_model as jbuild
from stofnet_tpu.train import steps as jsteps
from stofnet_tpu.train.loss import heatmap_loss as jheatmap
from stofnet_tpu.train.loss import regression_loss as jregression
from stofnet_tpu.models.registry import export_checkpoint as jexport
from stofnet_tpu_torch.models import build_model, variables_to_state_dict
from stofnet_tpu_torch.train import (
    LossConfig, load_model_variables, make_eval_step, make_optimizer,
    make_train_step,
)
from stofnet_tpu_torch.train.loss import heatmap_loss, regression_loss
from stofnet_tpu_torch.train.steps import dropout_seed

OV = dict(dataset_kind="chirp", upsample_factor=4, sample_num=200,
          rf_scale_factor=4, fs=1e6)
LENGTH = {"zonzini": 1600}
TRAINABLE = ("edsr", "espcn", "zonzini", "unet", "sincnet")
BN = ("unet", "sincnet", "kuleshov")
B = 2
# conv biases that a train-mode BatchNorm follows: the batch mean takes
# them out, so their gradient is 0
ZERO_GRAD = {"unet": r"((en|de)coder\.\d+\.main|middle)\.0\.bias",
             "sincnet": r"conv\.[1-9]\.bias"}


def length_of(name):
    return LENGTH.get(name, OV["sample_num"] * OV["rf_scale_factor"])


def kind(name):
    return "regression" if name == "zonzini" else "heatmap"


def up_of(name):
    return 1 if name in ("sincnet", "unet") else OV["upsample_factor"]


def loss_tol(name):
    return 1e-4 if name in BN else 1e-5


@functools.lru_cache(maxsize=None)
def setup(name, seed=1):
    """(JAX module, variables, the port's state dict, data)."""
    model, _ = jbuild(name, **OV)
    length = length_of(name)
    variables = jax.jit(model.init)(jax.random.key(seed),
                                    jnp.zeros((1, 1, length)))
    state = {k: torch.from_numpy(np.array(v)) for k, v in
             variables_to_state_dict(name, variables).items()}
    rng = np.random.default_rng(seed)
    frame = rng.standard_normal((B * 2, 1, length)).astype(np.float32)
    gt = rng.uniform(10, length - 10, (B * 2, 1)).astype(np.float32)
    gt_true = np.round(gt[:, None, :] * up_of(name)).astype(np.int32)
    return model, variables, state, (frame, gt, gt_true)


def port(name, state):
    model, _ = build_model(name, device="cpu", **OV)
    model.load_state_dict(state, strict=True)
    return model


def cfg_of(name):
    return dict(upsample_factor=up_of(name), max_echoes=8,
                model_kind=kind(name))


def jax_step(name, b=B, **kw):
    model, variables, _, data = setup(name)
    opt, _ = jsteps.make_optimizer(steps_per_epoch=1)
    step = jsteps.make_train_step(model, opt, jsteps.LossConfig(
        **cfg_of(name)), **kw)
    state = jsteps.init_train_state(variables, opt)
    new, aux = step(state, *(jnp.asarray(a[:b]) for a in data))
    return float(aux["loss"]), jax.tree.map(np.asarray, new.batch_stats)


def port_step(name, b=B, **kw):
    _, _, state, data = setup(name)
    model = port(name, state)
    opt, sched = make_optimizer(model.parameters(), steps_per_epoch=1)
    step = make_train_step(model, opt, sched, LossConfig(**cfg_of(name)),
                           **kw)
    aux = step(*(torch.from_numpy(a[:b]) for a in data))
    return float(aux["loss"]), model


def assert_stats(name, model, stats, rtol):
    """The port's BatchNorm buffers against flax's ``batch_stats``."""
    sd = variables_to_state_dict(name, {"batch_stats": stats})
    n = 0
    for k, v in sd.items():
        if k.endswith(("running_mean", "running_var")):
            got = model.state_dict()[k]
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), v, rtol=rtol,
                                       atol=rtol * np.abs(v).max(),
                                       err_msg=k)
            n += 1
    assert n


@pytest.mark.parametrize("name", TRAINABLE)
def test_train_step_loss_and_statistics_match_jax(name):
    ref, stats = jax_step(name)
    got, model = port_step(name)
    np.testing.assert_allclose(got, ref, rtol=loss_tol(name))
    if name in BN:
        assert_stats(name, model, stats, 1e-5)


def _jax_loss(name, train):
    model, _, _, _ = setup(name)
    cfg = cfg_of(name)

    def loss_fn(params, stats, frame, gt, gt_true):
        variables = {"params": params}
        if stats:
            variables["batch_stats"] = stats
        if train:
            pred, _ = model.apply(variables, frame, train=True,
                                  mutable=["batch_stats"])
        else:
            pred = model.apply(variables, frame)
        if cfg["model_kind"] == "regression":
            units = gt_true.reshape(gt.shape) // cfg["upsample_factor"]
            return jregression(pred, gt, units)[0]
        return jheatmap(pred, gt_true)[0]
    return loss_fn


@pytest.mark.parametrize("name", TRAINABLE + ("kuleshov",))
def test_gradients_match_jax(name):
    """Train mode (batch statistics) for all but Kuleshov, whose dropout
    draws differ: its gradient is held in eval mode."""
    train = name != "kuleshov"
    _, variables, state, data = setup(name)
    loss_fn = _jax_loss(name, train)
    ref_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        variables["params"], variables.get("batch_stats", {}),
        *(jnp.asarray(a[:B]) for a in data))
    ref = variables_to_state_dict(name, {"params": grads})

    model = port(name, state).train(train)
    frame, gt, gt_true = (torch.from_numpy(a[:B]) for a in data)
    pred = model(frame)
    if kind(name) == "regression":
        loss = regression_loss(pred, gt, gt_true.reshape(gt.shape)
                               // up_of(name))[0]
    else:
        loss = heatmap_loss(pred, gt_true)[0]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss),
                               rtol=loss_tol(name))
    params = dict(model.named_parameters())
    assert set(params) == set(ref)
    top = max(np.abs(g).max() for g in ref.values())
    for k, g_ref in ref.items():
        g = params[k].grad.numpy()
        if train and re.fullmatch(ZERO_GRAD.get(name, "$^"), k):
            # a conv bias under train-mode BatchNorm: its gradient is 0,
            # both sides hold rounding noise
            assert max(np.abs(g).max(), np.abs(g_ref).max()) <= 1e-6 * top
            continue
        np.testing.assert_allclose(g, g_ref, rtol=5e-3,
                                   atol=1e-3 * max(np.abs(g_ref).max(),
                                                   1e-12), err_msg=k)


def test_accum_chains_statistics_as_jax():
    """accum=2 on the unet: the statistics move through both micro-batches
    in order; the loss is the full batch's."""
    ref, stats = jax_step("unet", b=2 * B, accum=2)
    got, model = port_step("unet", b=2 * B, accum=2)
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    assert_stats("unet", model, stats, 1e-5)


def test_amp_keeps_f32_statistics_as_jax():
    ref, stats = jax_step("unet", amp=True)
    got, model = port_step("unet", amp=True)
    np.testing.assert_allclose(got, ref, rtol=2e-3)
    assert_stats("unet", model, stats, 4e-3)
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_remat_moves_statistics_once():
    _, plain = port_step("unet")
    loss_r, remat = port_step("unet", remat=True)
    for k, v in plain.state_dict().items():
        assert torch.equal(remat.state_dict()[k], v), k


def _kuleshov_losses(steps, seed=0):
    """The loss of a Kuleshov train step from the same weights at each
    scheduler count of ``steps``."""
    _, _, state, data = setup("kuleshov")
    out = []
    for n in steps:
        model = port("kuleshov", state)
        opt, sched = make_optimizer(model.parameters(), steps_per_epoch=1)
        sched.last_epoch = n
        step = make_train_step(model, opt, sched,
                               LossConfig(**cfg_of("kuleshov")), seed=seed)
        out.append(float(step(*(torch.from_numpy(a[:B])
                                for a in data))["loss"]))
    return out


def test_kuleshov_dropout_varies_by_step_and_is_seeded():
    """The masks come from the generator of (seed, step): the same step
    gives the same loss, another step or seed another one."""
    a, b, c = _kuleshov_losses([0, 0, 1])
    assert a == b and a != c
    assert _kuleshov_losses([0], seed=1)[0] != a
    assert dropout_seed(0, 1) != dropout_seed(0, 2) != dropout_seed(1, 1)


def test_regression_eval_step_matches_jax():
    model, variables, state, data = setup("zonzini")
    cfg = cfg_of("zonzini")
    ref = jsteps.make_eval_step(model, jsteps.LossConfig(**cfg))(
        variables, *(jnp.asarray(a) for a in data))
    got = make_eval_step(port("zonzini", state), LossConfig(**cfg))(
        *(torch.from_numpy(a) for a in data))
    np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(got["es_sample"].numpy(),
                               np.asarray(ref["es_sample"]), rtol=1e-5)
    assert got["es_sample"].shape == (2 * B, 1)
    np.testing.assert_allclose(got["toa_metrics"].numpy(),
                               np.asarray(ref["toa_metrics"]), rtol=1e-4,
                               atol=1e-6)


def test_bn_model_evaluates_on_running_statistics():
    """The eval step puts a BatchNorm model in eval mode after training:
    the running statistics, not the batch's, normalize."""
    _, _, state, data = setup("sincnet")
    model = port("sincnet", state)
    frame = torch.from_numpy(data[0])
    ev = make_eval_step(model, LossConfig(**cfg_of("sincnet")))
    pred, _ = ev.forward(frame)
    assert not model.training
    with torch.no_grad():
        assert not torch.allclose(model.train()(frame), pred)


@pytest.mark.parametrize("name", ["edsr", "unet", "kuleshov"])
def test_load_model_variables_reads_a_zoo_pth(name, tmp_path):
    """A reference .pth of a zoo family (JAX's export_checkpoint) loads
    through load_model_variables into the port's module strictly."""
    _, variables, state, _ = setup(name)
    jexport(name, variables, str(tmp_path / f"{name}-ckpt.pth"))
    loaded = load_model_variables(name, tmp_path / f"{name}-ckpt.pth")
    port(name, loaded)
    for k, v in state.items():
        assert torch.equal(loaded[k], v), k
