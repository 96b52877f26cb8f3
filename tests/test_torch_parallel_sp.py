"""The port's sequence parallelism (``stofnet_tpu_torch/parallel/seq.py``,
the sp axis of ``parallel/mesh.py`` and the sp half of ``train/steps.py``)
against JAX's single-device StofNet, on the CPU.

The sharded forward runs in one process, the shards in a loop (each its
window, the halo a slice of the row), against JAX's ``StofNet.apply`` at
``tests/test_parallel.py``'s rtol 1e-5, atol 1e-5. Four gloo ranks start
once, in a module-scoped fixture, and run ``scripts/dp_check.run_cases``
at dp=2 sp=2 (and the eval step at dp=1 sp=4, shards shorter than the
reach), the halo exchanged point to point; the same cases run alone in
this process on the whole batch. Tolerances are ``tests/test_parallel.py``'s
for the sharded step against one device (f32: the loss rtol 1e-5, 99.9 %
of the parameters within 1e-5 and all within 2 lr; amp: rtol 1e-2, 99 %
within 1e-4; the eval step's ``toa_metrics`` rtol 1e-5, atol 1e-5), the
same against JAX's single-device step, whose loss the port's f32 step
meets within 1e-4 (``tests/test_torch_train.py``) and its amp step
within 2e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stofnet_tpu.models import StofNet as JaxStofNet
from stofnet_tpu.parallel import batch_seq_sharding as jax_batch_seq_sharding
from stofnet_tpu.parallel import make_mesh as jax_make_mesh
from stofnet_tpu.parallel import shard_batch as jax_shard_batch
from stofnet_tpu.train import steps as jsteps
from stofnet_tpu_torch.cli import main as pmain
from stofnet_tpu_torch.models.fused import fused_forward
from stofnet_tpu_torch.models.stofnet import StofNet
from stofnet_tpu_torch.models.torch_import import params_to_state_dict
from stofnet_tpu_torch.parallel import mesh as pmesh
from stofnet_tpu_torch.parallel import seq
from stofnet_tpu_torch.scripts import dp_check
from stofnet_tpu_torch.serve import make_pipeline
from tests.test_torch_threads import share_cores

share_cores()  # this xdist worker's share of the cores

L, B, LR = 640, 8, 5e-4
ARCH = dict(upsample_factor=4, num_blocks=13, semi_global_scale=80)


def _jax_variables(length):
    return JaxStofNet(upsample_factor=4, semi_global_scale=80).init(
        jax.random.key(0), jnp.zeros((1, 1, length)))


def _port(variables, **kw):
    model = StofNet(device="cpu", **kw)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in
                           params_to_state_dict(variables).items()})
    return model.eval()


def _sharded(forward, x, dp, sp, arch=ARCH):
    """The heatmap of ``x`` computed as a (dp, sp) mesh of replicas does:
    each dp slice's rows split into sp windows, each window's forward
    cropped to its shard's positions, the shards joined in order."""
    rows = []
    for part in np.split(x, dp):
        rows.append(np.concatenate([
            seq.crop(forward(torch.from_numpy(np.ascontiguousarray(w))),
                     within, arch["upsample_factor"]).numpy()
            for w, within in seq.split_windows(part, sp, arch)], axis=-1))
    return np.concatenate(rows)


@pytest.mark.parametrize("length,dp,sp,batch", [
    (640, 4, 2, 8),    # tests/test_parallel.py:48
    (640, 1, 8, 2),    # 80-sample shards, far shorter than the reach
    (16000, 1, 8, 2),  # tests/test_parallel.py:248
    (8000, 1, 8, 2),   # 1000-sample shards: pool windows straddle them
    (1000, 1, 2, 2),   # L % 80 = 40: pad // 2 = 20 on every window
    (1000, 1, 4, 2),
])
def test_sharded_forward_matches_jax_single_device(length, dp, sp, batch):
    variables = _jax_variables(length)
    frame = np.random.default_rng(length + sp).standard_normal(
        (batch, 1, length)).astype(np.float32)
    ref = np.asarray(JaxStofNet(upsample_factor=4, semi_global_scale=80)
                     .apply(variables, jnp.asarray(frame)))
    model = _port(variables)
    with torch.no_grad():
        got = _sharded(model, frame, dp, sp)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sp", [2, 4])
def test_fused_route_plain_versions_sharded(sp):
    """The fused forward (its kernels' plain versions on the CPU, f32)
    on each shard's window equals the unsharded fused forward: the windows
    keep L % 80 == 0, so the route is the same on every shard."""
    length = 1600
    state = {k: torch.from_numpy(np.asarray(v)) for k, v in
             params_to_state_dict(_jax_variables(length)).items()}
    forward = fused_forward(state, dtype=torch.float32)
    x = np.random.default_rng(sp).standard_normal(
        (2, 1, length)).astype(np.float32)
    assert all((b - a) % 80 == 0
               for (a, b), _ in seq.windows(length, sp, ARCH))
    with torch.no_grad():
        want = forward(torch.from_numpy(x)).numpy()
        got = _sharded(forward, x, 1, sp)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _probe_reach(model, length, positions):
    """The largest distance between a perturbed input sample and an output
    position it moves (in input samples), over ``positions``."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 1, length)))
    batch = x.repeat(len(positions), 1, 1)
    for i, p in enumerate(positions):
        batch[i, 0, p] += 10.0
    with torch.no_grad():
        moved = (model(batch) - model(x)).abs().reshape(
            len(positions), length, -1).amax(-1) > 0
    worst = 0
    for i, p in enumerate(positions):
        at = torch.nonzero(moved[i]).flatten()
        worst = max(worst, int((at - p).abs().max()))
    return worst


@pytest.mark.parametrize("kw,length", [
    ({}, 958),  # L % 80 = 78: the largest centring, 39
    (dict(semi_global_scale=1, num_blocks=5), 200),
])
def test_reach_against_a_brute_force_probe(kw, length):
    """Perturb one input sample and see which outputs move: no output
    moves farther than ``reach`` (which the window rules rely on), and
    the farthest comes within a few samples of it (the bound is tight).
    Narrow f64 widths: the reach does not depend on them."""
    model = StofNet(num_features=4, generator=torch.Generator()
                    .manual_seed(0), device="cpu", **kw).double()
    r = seq.reach(**kw)
    positions = list(range(0, length, 3)) + [length - 1]
    probed = _probe_reach(model, length, positions)
    assert probed <= r
    assert probed >= r - 6, (probed, r)


def test_reach_and_windows_follow_the_rules():
    """The default reach, and each window's start on the pooling grid, its
    length = L (mod 80), its ends at the row's ends or R past the shard."""
    r = seq.reach()
    assert r == 318 and seq.reach(semi_global_scale=1) == 38
    for length, sp in ((8000, 2), (8000, 8), (1000, 4), (640, 8),
                       (16000, 8)):
        for k, ((a, b), (lo, hi)) in enumerate(
                seq.windows(length, sp, ARCH)):
            s0, s1 = a + lo, a + hi
            assert (s0, s1) == seq.shard_bounds(length, sp, k)
            assert a % 80 == 0 and (b - a) % 80 == length % 80
            assert a == 0 or s0 - a >= r
            assert b == length or b - s1 >= r
    with pytest.raises(ValueError, match="not divisible by mesh_sp=3"):
        seq.windows(1000, 3, ARCH)
    with pytest.raises(ValueError, match="keep the length"):
        seq.reach(kernel_sizes=(5, 7, 3))


def test_odd_pad_raises_on_every_shard_as_jax():
    """L % 80 odd: JAX raises for the whole row, and the port's windows
    keep that pad, so each shard raises the same way."""
    length, sp = 1041, 3  # L % 80 = 1
    variables = _jax_variables(1040)
    x = np.zeros((1, 1, length), np.float32)
    with pytest.raises(ValueError, match="must be even"):
        JaxStofNet(upsample_factor=4, semi_global_scale=80).apply(
            variables, jnp.asarray(x))
    model = _port(variables)
    for w, _ in seq.split_windows(x, sp, ARCH):
        assert w.shape[-1] % 80 == 1
        with pytest.raises(ValueError, match="must be even"), \
                torch.no_grad():
            model(torch.from_numpy(np.ascontiguousarray(w)))


def test_shard_batch_takes_what_jax_puts_on_each_device():
    """``shard_batch(seq_axis=2)`` of a (dp, sp) mesh of replicas, rank by
    rank, against the shards JAX's ``shard_batch`` puts on each device of
    its (4, 2) mesh (device r at dp r // 2, sp r % 2)."""
    x = np.arange(8 * 1 * 16, dtype=np.float32).reshape(8, 1, 16)
    jmesh = jax_make_mesh(dp=4, sp=2, devices=jax.devices()[:8])
    placed = jax_shard_batch(jmesh, jnp.asarray(x), seq_axis=2)
    devices = list(jmesh.devices.reshape(-1))
    assert jax_batch_seq_sharding(jmesh, 3, 2).spec == (
        pmesh.batch_seq_sharding(pmesh.make_mesh(4, 2, ["cpu"] * 8), 3,
                                 2).spec)
    for shard in placed.addressable_shards:
        r = devices.index(shard.device)
        mesh = pmesh.Mesh(4, 2, (torch.device("cpu"),) * 8, None, r)
        assert (mesh.dp_index, mesh.sp_index) == (r // 2, r % 2)
        np.testing.assert_array_equal(
            pmesh.shard_batch(mesh, x, seq_axis=2), np.asarray(shard.data))
        np.testing.assert_array_equal(   # GT: rows only
            pmesh.shard_batch(mesh, x[:, :, :3]), x[2 * (r // 2):
                                                    2 * (r // 2) + 2, :, :3])


def test_sp_groups_load_the_same_rows(tmp_path):
    """The driver's loader shard is the dp coordinate: the ranks of one sp
    group load the same rows with the same crop and noise, the dp rows
    differ, and the rows of a dp row are the single process's."""
    from stofnet_tpu_torch.data.loader import DataLoader
    from stofnet_tpu_torch.data.synthetic import generate_chirp_dataset
    from stofnet_tpu_torch.utils.config import load_config

    root = generate_chirp_dataset(tmp_path / "stof_chirp101_dataset",
                                  n_positions=2, n_train_per_pos=4,
                                  n_test_per_pos=1, sample_num=100)
    cfg = load_config(pmain.DEFAULT_CONFIG)
    cfg.update(data_dir=str(root), rf_scale_factor=4, device="cpu")

    def rows(shard):
        ds, _ = pmain.build_dataset(cfg.copy())
        loader = DataLoader(ds, batch_size=4, shuffle=True, drop_last=True,
                            seed=3, shard=shard)
        return [b[1] for b in loader]

    got = {}
    for r in range(4):
        mesh = pmesh.Mesh(2, 2, (torch.device("cpu"),) * 4, None, r)
        got[r] = rows(pmain._shard(mesh))
    whole = rows((0, 1))
    for d in range(2):
        for a, b, w in zip(got[2 * d], got[2 * d + 1], whole):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, w[2 * d:2 * d + 2])
    assert not np.array_equal(got[0][0], got[2][0])


# ---- four gloo ranks -----------------------------------------------------

@pytest.fixture(scope="module")
def runs():
    """{name: (case, the 4 ranks' result, the single process's result)}
    and JAX's StofNet variables."""
    variables = _jax_variables(L)
    state = {k: np.asarray(v)
             for k, v in params_to_state_dict(variables).items()}
    base = dp_check.stofnet_case(L, B, mesh=(2, 2))
    base["state"] = state
    eval_gt = np.full((B, 1), 100.0, np.float32)
    cases = {
        "f32": base, "amp": dict(base, amp=True),
        "accum2": dict(base, accum=2), "remat": dict(base, remat=True),
        "eval": dict(base, eval=True, gt_sample=eval_gt),
        "eval_sp4": dict(base, eval=True, gt_sample=eval_gt, mesh=(1, 4)),
    }
    names = list(cases)
    ranks = pmesh.launch(dp_check.run_cases,
                         ([cases[n] for n in names], "cpu"),
                         devices=["cpu"] * 4)
    alone = dp_check.run_cases([cases[n] for n in names], "cpu")
    out = {n: (cases[n], r, a) for n, r, a in zip(names, ranks, alone)}
    out["jax"] = variables
    return out


def _flat(tree):
    return np.concatenate([np.ravel(tree[k]) for k in sorted(tree)])


def _jax_step(variables, case, amp=False):
    cfg = jsteps.LossConfig(**case["loss"])
    optimizer, _ = jsteps.make_optimizer(steps_per_epoch=1)
    step = jsteps.make_train_step(
        JaxStofNet(upsample_factor=4, semi_global_scale=80), optimizer, cfg,
        amp=amp)
    gt = case["gt_sample"]
    gt_true = np.round(gt[:, :, None] * cfg.upsample_factor).astype(np.int32)
    new, aux = step(jsteps.init_train_state(variables, optimizer),
                    jnp.asarray(case["frame"]), jnp.asarray(gt),
                    jnp.asarray(gt_true))
    params = {k: np.asarray(v) for k, v in
              params_to_state_dict({"params": new.params}).items()}
    return float(aux["loss"]), params


def _assert_step(got_loss, got_params, want_loss, want_params, rtol, atol,
                 share):
    np.testing.assert_allclose(got_loss, want_loss, rtol=rtol)
    diff = np.abs(_flat(got_params) - _flat(want_params))
    assert np.mean(diff < atol) > share, f"max {diff.max()}"
    assert diff.max() < 2 * LR


@pytest.mark.parametrize("name,rtol,atol,share", [
    ("f32", 1e-5, 1e-5, 0.999), ("remat", 1e-5, 1e-5, 0.999),
    ("accum2", 1e-5, 1e-5, 0.999), ("amp", 1e-2, 1e-4, 0.99),
])
def test_dp_sp_step_matches_the_single_process_step(runs, name, rtol, atol,
                                                     share):
    """tests/test_parallel.py:60 (f32) and :110 (amp): the step on the
    (2, 2) mesh against the port's step on the whole batch."""
    _, got, one = runs[name]
    _assert_step(got["loss"], got["params"], one["loss"], one["params"],
                 rtol, atol, share)
    assert got["ranks_equal"]


@pytest.mark.parametrize("name,loss_rtol,atol,share", [
    ("f32", 1e-4, 1e-5, 0.999), ("amp", 2e-3, 1e-4, 0.99),
])
def test_dp_sp_step_matches_jax_single_device(runs, name, loss_rtol, atol,
                                              share):
    """The step on the (2, 2) mesh against JAX's single-device step of
    the global batch: the parameters by tests/test_parallel.py's rules."""
    case, got, _ = runs[name]
    jloss, jparams = _jax_step(runs["jax"], case, amp=case.get("amp", False))
    _assert_step(got["loss"][0], got["params"], jloss, jparams, loss_rtol,
                 atol, share)


@pytest.mark.parametrize("name", ["eval", "eval_sp4"])
def test_dp_sp_eval_step_matches_jax_single_device(runs, name):
    """The eval step with the sp group's heatmaps joined before the decode:
    the single process's outputs and JAX's single-device eval step
    (``toa_metrics`` rtol 1e-5), the heatmap JAX's forward at 1e-5."""
    case, got, one = runs[name]
    np.testing.assert_array_equal(got["es_sample"], one["es_sample"])
    np.testing.assert_allclose(got["masks_pred"], one["masks_pred"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-5)
    cfg = jsteps.LossConfig(**case["loss"])
    gt = jnp.asarray(case["gt_sample"])
    model = JaxStofNet(upsample_factor=4, semi_global_scale=80)
    ref = jsteps.make_eval_step(model, cfg)(
        runs["jax"], jnp.asarray(case["frame"]), gt,
        jnp.round(gt[:, :, None] * 4).astype(jnp.int32))
    np.testing.assert_allclose(got["toa_metrics"],
                               np.asarray(ref["toa_metrics"]), rtol=1e-5,
                               atol=1e-5, equal_nan=True)
    np.testing.assert_allclose(got["masks_pred"],
                               np.asarray(ref["masks_pred"]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got["loss"], float(ref["loss"]), rtol=1e-4)


def test_shard_loss_span_is_the_whole_masks_part():
    """``heatmap_loss(span=)``'s masks are the whole masks' positions:
    the shards' spike masks and blurs join into the unsharded ones, with
    a GT spike at a shard's first position and at global position 0."""
    from stofnet_tpu_torch.ops.gaussian import gaussian_kernel
    from stofnet_tpu_torch.train.loss import blurred_mask

    k = gaussian_kernel(7, 1.0)
    gt = torch.tensor([[[0, 3, 160, 161, 317, 320, 639]]], dtype=torch.int32)
    whole = blurred_mask(gt, 640, k)
    for n in (160, 80, 640):
        parts = [blurred_mask(gt, 640, k, (s, s + n))
                 for s in range(0, 640, n)]
        for i in range(2):
            torch.testing.assert_close(torch.cat([p[i] for p in parts], -1),
                                       whole[i], rtol=0, atol=0)


def test_pipeline_heatmap_and_decode_are_the_pipeline():
    """``make_pipeline``'s ``heatmap`` then ``decode`` give the pipeline's
    coords, each heatmap counted as a call of its route."""
    state = StofNet(generator=torch.Generator().manual_seed(0),
                    device="cpu").state_dict()
    pipe = make_pipeline(state, {"upsample_factor": 4}, device="cpu",
                         dtype=torch.float32, max_echoes=8)
    x = np.random.default_rng(0).standard_normal((2, 1, 800)).astype(
        np.float32)
    want = pipe(x)
    got = pipe.decode(pipe.heatmap(x))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert pipe.calls == {"fused": 2, "module": 0}
    assert pipe.arch == dict(ARCH)
