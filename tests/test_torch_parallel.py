"""The port's data parallelism (``stofnet_tpu_torch/parallel/mesh.py`` and
the dp half of ``train/steps.py``, ``models/batchnorm.py``,
``parallel/array.shard_members``) against the single-process port and
against JAX's single-device steps, on the CPU.

Two gloo ranks start once, in a module-scoped fixture, and run every
case of ``scripts/dp_check.run_cases`` (each rank its shard of one global
batch); the same cases run alone in this process on the whole batch.
Inputs are seeded numpy, weights JAX inits through
``params_to_state_dict`` / ``variables_to_state_dict``. Tolerances are
``tests/test_parallel.py``'s for the dp step against one device (f32:
the loss rtol 1e-5, 99.9 % of the parameters within 1e-5 and all within
2 lr; amp: rtol 1e-2, 99 % within 1e-4; BatchNorm statistics rtol 1e-5,
atol 1e-6, gradients rtol 1e-3, atol 1e-4 of the largest; the eval step
rtol 1e-5, atol 1e-5), the loss against JAX rtol 1e-4 (f32,
``tests/test_torch_train.py``) and 2e-3 (amp), the gradients against
JAX's rtol 5e-3, atol 1e-3 of the largest (the port's own against JAX's,
``tests/test_torch_zoo_train.py``), and
``tests/test_array.py``'s for member sharding (losses rtol 1e-5, atol
1e-6; parameters rtol 2e-5, atol 1e-5).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stofnet_tpu.models import SincNet as JaxSincNet
from stofnet_tpu.models import StofNet as JaxStofNet
from stofnet_tpu.parallel import make_mesh as jax_make_mesh
from stofnet_tpu.train import steps as jsteps
from stofnet_tpu.train.loss import heatmap_loss as jax_heatmap_loss
from stofnet_tpu_torch.models.batchnorm import BatchNorm
from stofnet_tpu_torch.models.registry import (
    build_model, variables_to_state_dict,
)
from stofnet_tpu_torch.models.torch_import import params_to_state_dict
from stofnet_tpu_torch.parallel import mesh as dp_mesh
from stofnet_tpu_torch.scripts import dp_check
from stofnet_tpu_torch.train.steps import (
    LossConfig, make_optimizer, make_train_step,
)
from tests.test_torch_threads import share_cores

share_cores()  # this xdist worker's share of the cores

L, B, LR = 640, 8, 5e-4
KULESHOV = dict(dataset_kind="chirp", upsample_factor=4, sample_num=200,
                rf_scale_factor=4)


def _stofnet():
    variables = JaxStofNet(upsample_factor=4, semi_global_scale=80).init(
        jax.random.key(0), jnp.zeros((1, 1, L)))
    frame = np.random.default_rng(0).standard_normal(
        (B, 1, L)).astype(np.float32)
    gt = np.random.default_rng(1).uniform(5, L - 5, (B, 1)).astype(
        np.float32)
    state = {k: np.asarray(v)
             for k, v in params_to_state_dict(variables).items()}
    return variables, dict(model="stofnet", arch={}, state=state,
                           frame=frame, gt_sample=gt,
                           loss=dict(upsample_factor=4, max_echoes=8))


def _sincnet():
    variables = JaxSincNet(sample_rate=1e6).init(jax.random.key(0),
                                                 jnp.zeros((1, 1, L)))
    state = {k: np.asarray(v) for k, v in
             variables_to_state_dict("sincnet", variables).items()}
    case = dp_check.sincnet_case(L, B)
    case["state"] = state
    return variables, case


@pytest.fixture(scope="module")
def runs():
    """{name: (case, the 2 ranks' result, the single process's result)},
    and the JAX variables of StofNet and SincNet."""
    jstof, stof = _stofnet()
    jsinc, sinc = _sincnet()
    rng = np.random.default_rng(4)
    kul = dict(model="kuleshov", arch=KULESHOV, seed=2, masks=True,
               frame=rng.standard_normal((4, 1, 800)).astype(np.float32),
               gt_sample=rng.uniform(10, 790, (4, 1)).astype(np.float32),
               loss=dict(upsample_factor=4, max_echoes=8))
    eval_gt = np.full((B, 1), 100.0, np.float32)
    cases = {
        "f32": stof, "amp": dict(stof, amp=True),
        "remat": dict(stof, remat=True), "accum2": dict(stof, accum=2),
        "eval": dict(stof, eval=True, gt_sample=eval_gt),
        "sincnet": sinc, "per_rank_stats": dict(sinc, per_rank_stats=True),
        "kuleshov": kul,
        "members": dict(stof, members=2, state=None, seed=5),
    }
    names = list(cases)
    ranks = dp_mesh.launch(dp_check.run_cases,
                           ([cases[n] for n in names], "cpu"),
                           devices=["cpu", "cpu"])
    alone = dp_check.run_cases([cases[n] for n in names], "cpu")
    out = {n: (cases[n], r, a) for n, r, a in zip(names, ranks, alone)}
    out["jax"] = {"stofnet": jstof, "sincnet": jsinc}
    return out


def _flat(tree):
    return np.concatenate([np.ravel(tree[k]) for k in sorted(tree)])


def _jax_step(variables, case, model, amp=False):
    """JAX's single-device train step on the whole batch: (loss, new
    state)."""
    cfg = jsteps.LossConfig(**case["loss"])
    optimizer, _ = jsteps.make_optimizer(steps_per_epoch=1)
    step = jsteps.make_train_step(model, optimizer, cfg, amp=amp)
    gt = case["gt_sample"]
    gt_true = np.round(gt[:, :, None] * cfg.upsample_factor).astype(np.int32)
    new, aux = step(jsteps.init_train_state(variables, optimizer),
                    jnp.asarray(case["frame"]), jnp.asarray(gt),
                    jnp.asarray(gt_true))
    return float(aux["loss"]), new


@pytest.mark.parametrize("name,rtol,atol,share", [
    ("f32", 1e-5, 1e-5, 0.999), ("remat", 1e-5, 1e-5, 0.999),
    ("accum2", 1e-5, 1e-5, 0.999), ("amp", 1e-2, 1e-4, 0.99),
])
def test_dp_step_matches_the_single_process_step(runs, name, rtol, atol,
                                                  share):
    """tests/test_parallel.py:60 (f32) and :108 (amp): the dp step on 2
    ranks against the port's step on the whole batch; remat and accum=2
    (the blurred mask's normaliser over the global batch) too."""
    _, dp, one = runs[name]
    np.testing.assert_allclose(dp["loss"], one["loss"], rtol=rtol)
    diff = np.abs(_flat(dp["params"]) - _flat(one["params"]))
    assert np.mean(diff < atol) > share, f"max {diff.max()}"
    assert diff.max() < 2 * LR


@pytest.mark.parametrize("name,rtol", [("f32", 1e-4), ("amp", 2e-3)])
def test_dp_step_loss_matches_jax(runs, name, rtol):
    """The dp step's loss against JAX's single-device step of the global
    batch."""
    case, dp, _ = runs[name]
    jloss, _ = _jax_step(runs["jax"]["stofnet"], case,
                         JaxStofNet(upsample_factor=4, semi_global_scale=80),
                         amp=case.get("amp", False))
    np.testing.assert_allclose(dp["loss"][0], jloss, rtol=rtol)


def _assert_stats(got, want):
    n = 0
    for k, v in want.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6,
                                       err_msg=k)
            n += 1
    assert n


def test_batchnorm_statistics_are_the_global_batch(runs):
    """tests/test_parallel.py:177: the SincNet dp step's running
    statistics are the global batch's, against the single process and
    JAX's single device; its loss against both."""
    case, dp, one = runs["sincnet"]
    _assert_stats(dp["buffers"], one["buffers"])
    np.testing.assert_allclose(dp["loss"], one["loss"], rtol=1e-5)
    jloss, new = _jax_step(runs["jax"]["sincnet"], case,
                           JaxSincNet(sample_rate=1e6))
    np.testing.assert_allclose(dp["loss"][0], jloss, rtol=1e-4)
    _assert_stats(dp["buffers"], variables_to_state_dict(
        "sincnet", {"batch_stats": jax.tree.map(np.asarray,
                                                new.batch_stats)}))


def test_batchnorm_gradients_flow_through_the_global_statistics(runs):
    """The dp gradients (summed over the ranks, divided by dp) against
    the single process's and JAX's single-device gradients of the global
    batch's train-mode loss."""
    case, dp, one = runs["sincnet"]
    variables = runs["jax"]["sincnet"]
    model = JaxSincNet(sample_rate=1e6)
    gt_true = jnp.asarray(np.round(case["gt_sample"][:, :, None]).astype(
        np.int32))

    def loss_fn(params):
        pred, _ = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(case["frame"]), train=True,
            rngs={"dropout": jax.random.key(0)}, mutable=["batch_stats"])
        return jax_heatmap_loss(pred, gt_true)[0]

    jgrads = variables_to_state_dict("sincnet", {"params": jax.tree.map(
        np.asarray, jax.grad(loss_fn)(variables["params"]))})
    assert dp["grads"].keys() == one["grads"].keys()
    for ref, rtol, atol in ((one["grads"], 1e-3, 1e-4),
                            (jgrads, 5e-3, 1e-3)):
        for k, g in dp["grads"].items():
            want = np.asarray(ref[k])
            scale = max(float(np.abs(want).max()), 1e-3)
            np.testing.assert_allclose(g, want, rtol=rtol,
                                       atol=atol * scale, err_msg=k)


def test_per_rank_statistics_miss_the_check(runs):
    """The control: BatchNorm on each rank's own statistics, as plain DDP
    computes them, fails the check the global statistics pass."""
    _, dp, one = runs["per_rank_stats"]
    with pytest.raises(AssertionError):
        _assert_stats(dp["buffers"], one["buffers"])


def test_dp_eval_step_matches_single(runs):
    """tests/test_parallel.py:282: the eval step's decode, metrics and
    loss of the global batch, against the single process and JAX."""
    case, dp, one = runs["eval"]
    for got in (dp,):
        np.testing.assert_allclose(got["toa_metrics"], one["toa_metrics"],
                                   rtol=1e-5, atol=1e-5, equal_nan=True)
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-5)
        np.testing.assert_array_equal(got["es_sample"], one["es_sample"])
        assert got["masks_pred"].shape == one["masks_pred"].shape
    cfg = jsteps.LossConfig(**case["loss"])
    gt = jnp.asarray(case["gt_sample"])
    ref = jsteps.make_eval_step(
        JaxStofNet(upsample_factor=4, semi_global_scale=80), cfg)(
        runs["jax"]["stofnet"], jnp.asarray(case["frame"]), gt,
        jnp.round(gt[:, :, None] * 4).astype(jnp.int32))
    np.testing.assert_allclose(dp["toa_metrics"],
                               np.asarray(ref["toa_metrics"]), rtol=1e-5,
                               atol=1e-5, equal_nan=True)
    np.testing.assert_allclose(dp["loss"], float(ref["loss"]), rtol=1e-4)


def test_kuleshov_masks_are_the_single_process_masks(runs):
    """Each rank draws the global batch's dropout masks from the step's
    generator and keeps its rows: the masks the single process draws, so
    the loss agrees."""
    _, dp, one = runs["kuleshov"]
    assert len(dp["masks"]) == len(one["masks"]) > 0
    for a, b in zip(dp["masks"], one["masks"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(dp["loss"], one["loss"], rtol=1e-5)


@pytest.mark.parametrize("name", ["f32", "amp", "remat", "accum2",
                                  "sincnet", "kuleshov"])
def test_ranks_hold_rank_0s_parameters_bit_for_bit(runs, name):
    _, dp, _ = runs[name]
    assert dp["ranks_equal"]


def test_shard_members_matches_the_unsharded_vmap(runs):
    """tests/test_array.py:166: N=2 members over dp=2, a member a rank,
    against both on one rank."""
    _, dp, one = runs["members"]
    np.testing.assert_allclose(dp["loss"], one["loss"], rtol=1e-5,
                               atol=1e-6)
    assert dp["params"].keys() == one["params"].keys()
    for k, v in dp["params"].items():
        np.testing.assert_allclose(v, one["params"][k], rtol=2e-5,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("kw,n", [
    (dict(dp=3), 4), (dict(sp=3), 4), (dict(dp=2, sp=1), 4),
])
def test_make_mesh_refuses_as_jax(kw, n):
    """JAX's refusals word for word, on n devices."""
    with pytest.raises(ValueError) as want:
        jax_make_mesh(devices=jax.devices()[:n], **kw)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        dp_mesh.make_mesh(devices=["cpu"] * n, **kw)


@pytest.mark.parametrize("call", [
    lambda m: dp_mesh.make_mesh(dp=2, sp=2, devices=["cpu"] * 4).shape,
    lambda m: dp_mesh.batch_seq_sharding(m, 3, seq_axis=2).spec,
    lambda m: dp_mesh.shard_batch(
        dp_mesh.Mesh(1, 2, (torch.device("cpu"),) * 2), np.zeros((2, 4)),
        seq_axis=1).shape,
], ids=["make_mesh", "batch_seq_sharding", "shard_batch"])
def test_sp_is_refused_naming_a6b(call):
    """The three calls that refused sp > 1 until ROADMAP A.6b now run, as
    JAX's: a (2, 2) mesh, the (dp, None, sp) spec, a rank's samples."""
    mesh = dp_mesh.make_mesh(dp=2, devices=["cpu"] * 2)
    assert call(mesh) in ({"dp": 2, "sp": 2}, ("dp", None, "sp"), (2, 2))


def test_mesh_outside_a_group_holds_replicas():
    """Explicit devices, no process group: the daemon's replicas; dp
    defaults to the device count over sp, and shard_batch takes rank 0's
    rows, scalars replicate."""
    mesh = dp_mesh.make_mesh(devices=["cpu"] * 4)
    assert mesh.shape == {"dp": 4, "sp": 1} and mesh.group is None
    assert mesh.device == torch.device("cpu") and mesh.rank == 0
    x = np.arange(8)
    tree = dp_mesh.shard_batch(mesh, {"x": x, "s": np.float32(3.0)})
    np.testing.assert_array_equal(tree["x"], [0, 1])
    assert tree["s"] == 3.0
    assert dp_mesh.batch_sharding(mesh, 3).spec == ("dp", None, None)
    with pytest.raises(ValueError, match="not divisible by mesh_dp=4"):
        dp_mesh.shard_batch(mesh, np.zeros(6))


def test_a_step_without_a_mesh_clears_batchnorms_mesh():
    """A model that took a dp step's mesh and then a step without one
    normalises by its own batch again: the second step's BatchNorm
    statistics are those of a model that never saw the mesh."""
    case = dp_check.sincnet_case(L, 4)
    batch = [torch.from_numpy(case["frame"]),
             torch.from_numpy(case["gt_sample"]),
             torch.from_numpy(np.round(case["gt_sample"][:, None, :])
                              .astype(np.int32))]
    stats = []
    for earlier in (dp_mesh.make_mesh(dp=2, devices=["cpu"] * 2), None):
        model, _ = build_model("sincnet", device="cpu", **case["arch"],
                               generator=torch.Generator().manual_seed(3))
        cfg = LossConfig(**case["loss"])
        opt, sched = make_optimizer(model.parameters(), steps_per_epoch=1)
        make_train_step(model, opt, sched, cfg, mesh=earlier)
        step = make_train_step(model, opt, sched, cfg)
        assert all(m.mesh is None for m in model.modules()
                   if isinstance(m, BatchNorm))
        step(*batch)
        stats.append({k: v.clone() for k, v in model.named_buffers()})
    for k, v in stats[1].items():
        torch.testing.assert_close(stats[0][k], v, rtol=0, atol=0)
