"""The model zoo under sequence parallelism (``stofnet_tpu_torch/parallel/
seq.py``'s family rules, the shard forms of ``models/{espcn1d,edsr1d,
sincnet,wave_unet,zonzini,kuleshov}.py``, BatchNorm's statistics
over own positions in ``models/batchnorm.py``) and ``accum`` on a mesh
(``utils/collectives.accum_rows``), against JAX's single device, on the CPU.

The sharded forwards run in one process (``parallel/seq.local_forward``:
a thread a shard, joined through a ``ThreadExchange``) against JAX's
``apply`` of the same weights at ``tests/test_parallel.py``'s rtol 1e-5,
atol 1e-5 (SincNet, whose 1023-tap sums the port's unsharded forward
meets within rtol 2e-3, ``tests/test_torch_zoo_models.py``, at that) and
against the port's unsharded forward at 1e-6. Four gloo ranks start once,
in a module-scoped fixture, and run ``scripts/dp_check.run_cases`` at
dp=2 sp=2 for every family (train and eval), the same cases alone in this
process on the whole batch. The step tolerances are
``tests/test_parallel.py``'s for a sharded step against one device (the
loss rtol 1e-5, 99.9 % of the parameters within 1e-5 and all within 2
lr, BatchNorm statistics rtol 1e-5, atol 1e-6); the eval step's rows
equal and its metrics rtol 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stofnet_tpu.models import build_model as jbuild
from stofnet_tpu.train import steps as jsteps
from stofnet_tpu_torch.data.loader import DataLoader
from stofnet_tpu_torch.data.synthetic import gate_batch
from stofnet_tpu_torch.models import build_model, variables_to_state_dict
from stofnet_tpu_torch.models import zonzini
from stofnet_tpu_torch.ops.resample import linear_resample
from stofnet_tpu_torch.parallel import mesh as pmesh
from stofnet_tpu_torch.parallel import seq
from stofnet_tpu_torch.scripts import dp_check
from stofnet_tpu_torch.scripts.mesh_serve_check import ZONZINI_RTOL
from stofnet_tpu_torch.utils.collectives import accum_rows
from tests.test_torch_threads import share_cores

share_cores()  # this xdist worker's share of the cores

LR = 5e-4
FS = 1e6
ZOO = ("espcn", "edsr", "sincnet", "unet", "zonzini", "kuleshov", "gradpeak")
# the registry's chirp arguments at a small size; each family's row
OV = dict(dataset_kind="chirp", upsample_factor=4, rf_scale_factor=4, fs=FS)
LENGTH = {"zonzini": 4096, "kuleshov": 800}


def length_of(name):
    return LENGTH.get(name, 1024)


@functools.lru_cache(maxsize=None)
def jax_model(name, seed=1):
    """(JAX module, its variables, the port's module of them in eval
    mode)."""
    n = length_of(name)
    kw = dict(OV, sample_num=n // 4)
    jm, _ = jbuild(name, th=None, **kw)
    port, _ = build_model(name, th=None, device="cpu", **kw)
    if name == "gradpeak":
        return jm, {}, port.eval()
    variables = jax.jit(jm.init)(jax.random.key(seed), jnp.zeros((1, 1, n)))
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                          variables_to_state_dict(name, variables).items()})
    return jm, variables, port.eval()


def _sharded(model, x, sp):
    outs = seq.local_forward(model, torch.from_numpy(x), sp,
                             seq.model_arch(model))
    arch = seq.model_arch(model)
    return (torch.cat(outs, -1) if arch["family"] in seq.HEATMAP
            else outs[0]).numpy()


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("name", ZOO)
def test_sharded_forward_matches_jax_single_device(name, sp):
    """Each family's shard form at sp = 2 and 4 (at L = 1024, SincNet's
    and the unet's windows at sp = 4 reach both ends of the row) against
    JAX's single-device forward and the port's unsharded one; GradPeak's
    rows exact."""
    jm, variables, model = jax_model(name)
    rng = np.random.default_rng(sp)
    x = gate_batch(3, length_of(name), rng)
    ref = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        whole = model(torch.from_numpy(x)).numpy()
    got = _sharded(model, x, sp)
    assert got.shape == ref.shape
    if name == "gradpeak":
        np.testing.assert_array_equal(got, whole)
        assert (ref > 0).all()
    np.testing.assert_allclose(got, whole, rtol=1e-6, atol=1e-6)
    rtol, atol = (2e-3, 1e-3 * np.abs(ref).max()) if name == "sincnet" \
        else (1e-5, 1e-5)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


def _probe_reach(model, length, positions):
    """The largest distance between a perturbed input sample and an output
    position it moves (in input samples), over ``positions``."""
    r = seq.model_arch(model)["upsample_factor"]
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 1, length)))
    batch = x.repeat(len(positions), 1, 1)
    for i, p in enumerate(positions):
        batch[i, 0, p] += 10.0
    with torch.no_grad():
        moved = (model(batch) - model(x)).abs().reshape(
            len(positions), length, r).amax(-1) > 0
    worst = 0
    for i, p in enumerate(positions):
        at = torch.nonzero(moved[i]).flatten()
        worst = max(worst, int((at - p).abs().max()))
    return worst


@pytest.mark.parametrize("name,kw,length,slack", [
    ("espcn", {}, 200, 0), ("edsr", dict(num_blocks=3), 200, 1),
    ("sincnet", dict(n_filt=(4, 4, 4, 1)), 1400, 0),
    ("unet", dict(n_layers=3, channels_interval=2), 512, 40),
])
def test_reach_against_a_brute_force_probe(name, kw, length, slack):
    """Perturb one input sample and see which outputs move: none farther
    than the family's ``reach`` (the window rule relies on it), the
    farthest within ``slack`` of it (the bound is tight up to the unet's
    alignment and resample terms). Narrow f64 widths."""
    cls = {"espcn": "ESPCN1D", "edsr": "EDSR1D", "sincnet": "SincNet",
           "unet": "WaveUnet"}[name]
    import stofnet_tpu_torch.models as models
    extra = dict(sample_rate=FS) if name == "sincnet" else {}
    model = getattr(models, cls)(generator=torch.Generator().manual_seed(0),
                                 device="cpu", **kw, **extra).double().eval()
    r = seq.model_arch(model)["reach"]
    positions = list(range(0, length, 3)) + [length - 1]
    probed = _probe_reach(model, length, positions)
    assert probed <= r
    assert probed >= r - slack, (probed, r)


def test_window_rules_of_the_grids():
    """The unet's windows start and stop on its 2**n grid; at PALA's ten
    layers the reach spans a 10240-sample row, whose window is the whole
    row. Zonzini's windows partition the last stage's positions and start
    on its 4**stages grid; a shard that holds none keeps none."""
    unet = build_model("unet", n_layers=10, device="meta")[0]
    arch = seq.model_arch(unet)
    assert arch["reach"] > 10240
    assert [w for w, _ in seq.windows(10240, 2, arch)] == [(0, 10240)] * 2
    assert seq.redundant_share(10240, 2, arch) == 1.0
    arch = seq.model_arch(build_model("unet", device="meta")[0])
    for (a, b), _ in seq.windows(1600, 4, arch):
        assert a % 4 == 0 and b % 4 == 0
    for length, sp in ((4096, 2), (4096, 4), (8000, 4), (8000, 8)):
        spans = zonzini.shard_windows(length, sp, 4)
        w = zonzini.final_length(length, 4)
        own = [hi - lo for _, (lo, hi, _) in spans]
        assert sum(own) == w and all(c == w for _, (_, _, c) in spans)
        assert all(a % 256 == 0 for (a, _), _ in spans)
    assert [hi - lo for _, (lo, hi, _) in
            zonzini.shard_windows(8000, 8, 4)][-1] == 0


@pytest.mark.parametrize("control", [None, "twice", "dropped"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_zonzini_sharded_pool_has_the_single_forward_s_bits(
        monkeypatch, dtype, control):
    """Zonzini's pool sums in f64 and rounds once, so its sharded forward
    at sp = 2 and 4 (L=8000, the chip's length) equals the single
    forward's bit for bit in f32 and in bf16. Controls: shard 0's part of
    the pool counted twice, or dropped, miss ``ZONZINI_RTOL``."""
    kw = dict(OV, sample_num=2000)
    model = build_model("zonzini", th=None, device="cpu", dtype=dtype,
                        generator=torch.Generator().manual_seed(2),
                        **kw)[0].eval()
    x = torch.from_numpy(gate_batch(8, 8000, np.random.default_rng(4)))
    with torch.no_grad():
        whole = model(x)
    if control is not None:
        plain = seq.ThreadExchange.sum
        scale = 2.0 if control == "twice" else 0.0

        def planted(self, t):
            return plain(self, t * scale if self.index == 0 else t)
        monkeypatch.setattr(seq.ThreadExchange, "sum", planted)
    for sp in (2, 4):
        got = seq.local_forward(model, x, sp, seq.model_arch(model))[0]
        if control is None:
            assert torch.equal(got, whole), sp
        else:
            rel = ((got - whole).abs() / whole.abs()).max()
            assert rel > ZONZINI_RTOL, (sp, float(rel))


def test_resample_window_is_the_rows_part():
    """``linear_resample(window=)`` of a row's part is the part of the
    row's resampling (align-corners: not shift-invariant), inside the
    window's edges."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 64, 3)))
    whole = linear_resample(x, 128, axis=1)
    got = linear_resample(x[:, 16:40], 48, axis=1, window=(64, 128, 16, 32))
    torch.testing.assert_close(got[:, 2:-2], whole[:, 34:78])


def test_accum_rows_are_each_rank_s_part_of_jax_s_micro_batches():
    """Under ``accum`` N rank r holds block r of each micro-batch, in
    order, so its chunk i is its part of global rows [i B / N, (i+1) B /
    N); the loader and ``shard_batch`` take those rows."""
    assert accum_rows(8, 2, 0).tolist() == [0, 1, 2, 3]
    assert accum_rows(8, 2, 1, 2).tolist() == [2, 3, 6, 7]
    assert accum_rows(12, 2, 0, 3).tolist() == [0, 1, 4, 5, 8, 9]
    with pytest.raises(ValueError, match="mesh_dp \\* accum"):
        accum_rows(6, 2, 0, 2)
    items = [(np.float32(i),) for i in range(16)]
    rows = [next(iter(DataLoader(items, batch_size=8, drop_last=True,
                                 shard=(r, 2), accum=2)))[0]
            for r in range(2)]
    assert rows[1].tolist() == [2, 3, 6, 7]
    mesh = pmesh.Mesh(2, 1, (torch.device("cpu"),) * 2, None, 1)
    x = np.arange(8)[:, None]
    assert pmesh.shard_batch(mesh, x, accum=2)[:, 0].tolist() == [2, 3, 6, 7]


# ---- four gloo ranks -----------------------------------------------------

def _case(name, **kw):
    jm, variables, model = jax_model(name)
    case = dp_check.zoo_case(name, length_of(name), 4, seed=3, mesh=(2, 2),
                             **kw)
    case["arch"] = dict(OV, sample_num=length_of(name) // 4, th=None)
    if name != "gradpeak":
        case["state"] = {k: v.numpy() for k, v in model.state_dict().items()}
    return case


TRAIN = ("espcn", "edsr", "sincnet", "unet", "zonzini", "kuleshov")


@pytest.fixture(scope="module")
def runs():
    """{name: (case, rank 0's result, the single process's result)}."""
    cases = {}
    for name in TRAIN:
        cases[name] = _case(name)
    for name in ZOO:
        cases[f"{name}_eval"] = _case(name, eval=True)
    for name in ("unet", "kuleshov"):
        cases[f"{name}_accum2"] = _case(name, accum=2, masks=True)
        cases[f"{name}_accum2_contiguous"] = _case(
            name, accum=2, masks=True, contiguous_rows=True)
    cases["unet_halo_stats"] = _case("unet", halo_stats=True)
    names = list(cases)
    ranks = pmesh.launch(dp_check.run_cases,
                         ([cases[n] for n in names], "cpu"),
                         devices=["cpu"] * 4)
    alone = dp_check.run_cases([cases[n] for n in names], "cpu")
    return {n: (cases[n], r, a) for n, r, a in zip(names, ranks, alone)}


def _flat(tree):
    return np.concatenate([np.ravel(tree[k]) for k in sorted(tree)])


def _share_within(got, want, atol=1e-5):
    diff = np.abs(_flat(got) - _flat(want))
    return float(np.mean(diff < atol)), float(diff.max())


def _stats(tree):
    return {k: v for k, v in tree.items()
            if k.endswith(("running_mean", "running_var"))}


BN = ("sincnet", "unet", "kuleshov")


def _assert_step(got, one, name):
    """``tests/test_torch_parallel.py``'s rules: the loss rtol 1e-5, every
    parameter within 2 lr; 99.9 % of them within 1e-5, or, for a
    BatchNorm family (whose conv biases before a BatchNorm have a
    gradient of rounding noise, which AdamW's first step turns into
    updates of up to lr either way), the gradients rtol 1e-3, atol 1e-4
    of the model's largest and the running statistics rtol 1e-5, atol
    1e-6."""
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-5)
    share, worst = _share_within(got["params"], one["params"])
    assert worst < 2 * LR, worst
    if name not in BN:
        assert share > 0.999, share
        return
    scale = max(float(np.abs(g).max()) for g in one["grads"].values())
    for k, g in got["grads"].items():
        np.testing.assert_allclose(g, one["grads"][k], rtol=1e-3,
                                   atol=1e-4 * scale, err_msg=k)
    for k, v in _stats(one["buffers"]).items():
        np.testing.assert_allclose(got["buffers"][k], v, rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", TRAIN)
def test_dp_sp_step_matches_the_single_process_step(runs, name):
    """One f32 step of every trainable family on the (2, 2) mesh against
    the port's step on the whole batch (:func:`_assert_step`); every rank
    holds the same parameters."""
    _, got, one = runs[name]
    _assert_step(got, one, name)
    assert got["ranks_equal"]


@pytest.mark.parametrize("name", ZOO)
def test_dp_sp_eval_step_matches_the_single_process(runs, name):
    """The eval step of every family on the (2, 2) mesh: the decoded rows
    equal (Zonzini's prediction, a sum in another order, rtol 1e-5), the
    predictions rtol 1e-5, atol 1e-5 of the largest (a window's conv may
    take another algorithm than the row's), the metrics and loss rtol
    1e-5 of the single process's."""
    _, got, one = runs[f"{name}_eval"]
    if name == "zonzini":
        np.testing.assert_allclose(got["es_sample"], one["es_sample"],
                                   rtol=1e-5)
    else:
        np.testing.assert_array_equal(got["es_sample"], one["es_sample"])
    np.testing.assert_allclose(
        got["masks_pred"], one["masks_pred"], rtol=1e-5,
        atol=1e-5 * float(np.abs(one["masks_pred"]).max()))
    np.testing.assert_allclose(got["toa_metrics"], one["toa_metrics"],
                               rtol=1e-5, atol=1e-5, equal_nan=True)
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-5)


@pytest.mark.parametrize("name", ["unet", "kuleshov"])
def test_accum_on_a_mesh_holds_jax_s_micro_batches(runs, name):
    """accum=2 on the (2, 2) mesh against the single process at accum=2:
    the parameters, BatchNorm's running statistics (chained through the
    micro-batches) and Kuleshov's dropout masks; with each rank's
    contiguous block (the row choice before the repair) the statistics
    and the masks of a micro-batch are other rows', and the check
    misses."""
    _, got, one = runs[f"{name}_accum2"]
    _, bad, _ = runs[f"{name}_accum2_contiguous"]
    _assert_step(got, one, name)
    stats = _stats(one["buffers"])
    misses = [not np.allclose(bad["buffers"][k], v, rtol=1e-5, atol=1e-6)
              for k, v in stats.items()]
    assert any(misses)
    if name == "kuleshov":  # each micro-batch's masks, drawn whole
        assert len(got["masks"]) == len(one["masks"]) == 10
        for g, w in zip(got["masks"], one["masks"]):
            np.testing.assert_array_equal(g, w)


def test_accum_on_a_mesh_matches_jax_single_device(runs):
    """The unet's accum=2 step on the (2, 2) mesh against JAX's
    single-device step at accum=2: the loss rtol 1e-4, the parameters
    within 2 lr and the running statistics rtol 1e-4."""
    case, got, _ = runs["unet_accum2"]
    jm, variables, _ = jax_model("unet")
    cfg = jsteps.LossConfig(**case["loss"])
    optimizer, _ = jsteps.make_optimizer(steps_per_epoch=1)
    step = jsteps.make_train_step(jm, optimizer, cfg, accum=2)
    gt = case["gt_sample"]
    gt_true = np.round(gt[:, :, None] * cfg.upsample_factor).astype(np.int32)
    new, aux = step(jsteps.init_train_state(variables, optimizer),
                    jnp.asarray(case["frame"]), jnp.asarray(gt),
                    jnp.asarray(gt_true))
    want = {k: np.asarray(v) for k, v in variables_to_state_dict(
        "unet", {"params": new.params, "batch_stats": new.batch_stats})
        .items()}
    np.testing.assert_allclose(got["loss"][0], float(aux["loss"]), rtol=1e-4)
    _, worst = _share_within(got["params"],
                             {k: want[k] for k in got["params"]})
    assert worst < 2 * LR, worst
    for k, v in _stats(got["buffers"]).items():
        np.testing.assert_allclose(v, want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_halo_in_batchnorm_statistics_misses(runs):
    """The control: the unet's step with BatchNorm's statistics over each
    shard's whole window (the halo counted twice) moves the running
    statistics off the single process's, where the own-position rule
    holds them (``test_dp_sp_step_matches_the_single_process_step``)."""
    _, bad, one = runs["unet_halo_stats"]
    stats = _stats(one["buffers"])
    misses = [not np.allclose(bad["buffers"][k], v, rtol=1e-5, atol=1e-6)
              for k, v in stats.items()]
    assert sum(misses) >= len(stats) // 2
