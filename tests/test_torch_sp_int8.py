"""The int8 route under sequence parallelism, on the CPU: the sharded
int8 forward (``models/int8.stofnet_apply_int8(shard=)`` on StofNet's
windows, its activation scales joined over the sp group), the daemon's
int8 route from a checkpoint under ``mesh_sp`` (``cli/serve.py``) and
the driver's ``evaluate=True int8=True`` under ``mesh_sp``
(``cli/main.py``; one spawn of two gloo ranks), against the port's
single int8 forward and JAX's.

Weights: a JAX ``StofNet().init`` through ``params_to_state_dict``.
Tolerances:
- the sharded forward and the sharded daemon bit for bit to the port's
  single int8 forward (a max is exact in any order, and every window
  computes its own positions as the row does);
- the sharded forward against JAX's ``stofnet_apply_int8`` on the whole
  row, fed the same quantized state, in f32 to
  ``tests/test_torch_int8.py``'s tolerances: the default's heatmap to
  rtol 2e-3, atol 2e-4 * max|heatmap|, and the decoded coords within 1
  sample (with every stack conv in s8 an f32 conv summed in another
  order moves a code at a rounding boundary, as it does for the single
  forward: that test holds the stack's codes only away from one);
- a planted control (each window quantized with its own scale, not
  joined) misses that gate on a batch whose loud echo lies in one shard;
- the driver's metrics by ``tests/test_cli_e2e.py:241``'s gates
  (``_metrics_match``) against one process and against JAX's driver.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stofnet_tpu.cli import main as jmain
from stofnet_tpu.models import StofNet as JaxStofNet
from stofnet_tpu.models import int8 as jint8
from stofnet_tpu.utils.config import load_config as jload_config
from stofnet_tpu_torch.cli import main as pmain
from stofnet_tpu_torch.cli.serve import build
from stofnet_tpu_torch.data.synthetic import (
    gate_batch, generate_chirp_dataset,
)
from stofnet_tpu_torch.models import int8 as tint8
from stofnet_tpu_torch.ops.peaks import mask2coords
from stofnet_tpu_torch.models.torch_import import (
    params_to_state_dict, save_torch_state_dict,
)
from stofnet_tpu_torch.parallel import seq
from stofnet_tpu_torch.parallel.mesh import live
from stofnet_tpu_torch.serve import make_pipeline
from stofnet_tpu_torch.serving import ServingClient
from stofnet_tpu_torch.utils.config import load_config
from tests.test_torch_cli_mesh_sp import _metrics_match
from tests.test_torch_threads import share_cores

share_cores()  # this xdist worker's share of the cores

L = 800
ARCH = dict(family="stofnet", upsample_factor=4, num_blocks=13,
            semi_global_scale=80, int8=True)
STACK = dict(stack_layers=tuple(range(2, 13)), eq_alpha=0.5,
             bias_correct=True)
RF = 4


@pytest.fixture(scope="module")
def weights():
    variables = JaxStofNet().init(jax.random.key(0), jnp.zeros((1, 1, L)))
    return variables, {k: torch.tensor(v)
                       for k, v in params_to_state_dict(variables).items()}


def _rows(length, seed, batch=3):
    return torch.from_numpy(gate_batch(batch, length,
                                       np.random.default_rng(seed)))


def _assert_heat_close(got, ref):
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=2e-3,
                               atol=2e-4 * np.abs(ref).max())


def _sharded(q, x, sp, **kw):
    """The int8 forward of ``x`` over ``sp`` shards, a thread each,
    joined through ``parallel/seq.ThreadExchange``."""
    outs = seq.local_forward(
        lambda xs, shard: tint8.stofnet_apply_int8(q, xs, shard=shard, **kw),
        x, sp, ARCH)
    return torch.cat(outs, -1)


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("length", [800, 840])
@pytest.mark.parametrize("kw", [{}, STACK], ids=["default", "stack_eq_bc"])
def test_sharded_int8_matches_one_forward_and_jax(weights, kw, length, sp):
    """At sp = 2 and 4, at L % 80 == 0 and at 840 (the pooled pathway
    padded, every last window reaching the row's end), the default and
    every stack conv in s8 with equalization and bias correction: the
    shards' rows are the single forward's bits and JAX's whole-row
    forward's within the int8 test's gate."""
    _, state = weights
    x = _rows(length, seed=length + sp)
    q = tint8.quantize_stofnet(state, x, **kw)
    sl = kw.get("stack_layers")
    one = tint8.stofnet_apply_int8(q, x, dtype=None, stack_layers=sl)
    got = _sharded(q, x, sp, dtype=None, stack_layers=sl)
    assert torch.equal(got, one)
    jq = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), q)
    ref = np.asarray(jint8.stofnet_apply_int8(
        jq, jnp.asarray(x.numpy()), dtype=None, stack_layers=sl))
    if not kw:
        _assert_heat_close(got.numpy(), ref)
    coords = [mask2coords(h, window_size=20, threshold=None,
                          upsample_factor=4, max_echoes=8).numpy()
              for h in (got, torch.tensor(ref))]
    assert np.all(np.abs(coords[0] - coords[1]) <= 1.0)
    bf16 = _sharded(q, x, sp, stack_layers=sl)
    assert torch.equal(bf16, tint8.stofnet_apply_int8(q, x, stack_layers=sl))


class _Unjoined:
    """An exchange that joins nothing: each window's max is its own."""

    def max(self, t):
        return t


@pytest.mark.parametrize("kw", [{}, STACK], ids=["default", "stack_eq_bc"])
def test_unjoined_scales_miss(weights, kw):
    """The planted control: each shard quantizes its window with its own
    scale. On rows whose loud echo lies in the first of two shards, the
    second shard's codes are finer than the row's, and its rows miss the
    gate that the joined scales meet."""
    _, state = weights
    x = _rows(L, seed=9) * 0.01
    x[..., 100:140] += 1.0  # the loud echo, in shard 0's own samples
    q = tint8.quantize_stofnet(state, x, **kw)
    sl = kw.get("stack_layers")
    one = tint8.stofnet_apply_int8(q, x, dtype=None, stack_layers=sl)
    outs = []
    for k in range(2):
        shard = seq.shard_of(ARCH, L, 2, k, _Unjoined())
        a, b = shard.window
        outs.append(seq.own_output(ARCH, tint8.stofnet_apply_int8(
            q, x[..., a:b], dtype=None, stack_layers=sl, shard=shard),
            shard))
    control = torch.cat(outs, -1)
    with pytest.raises(AssertionError):
        _assert_heat_close(control.numpy(), one.numpy())
    assert torch.equal(_sharded(q, x, 2, dtype=None, stack_layers=sl), one)


@pytest.fixture(scope="module")
def ckpt(weights, tmp_path_factory):
    """A checkpoint of the weights and a calibration batch on disk."""
    _, state = weights
    d = tmp_path_factory.mktemp("sp_int8")
    save_torch_state_dict({k: v.numpy() for k, v in state.items()},
                          str(d / "armadillo-seed0.pth"))
    calib = gate_batch(8, L, np.random.default_rng(40))
    np.save(d / "calib.npy", calib)
    return d, calib


@pytest.mark.parametrize("sp,dtype,stack", [
    (2, "float32", None), (4, "bfloat16", None),
    (2, "bfloat16", "2,3,4,5,6,7,8,9,10,11,12"),
], ids=["sp2_f32", "sp4_bf16", "sp2_bf16_stack"])
def test_sp_daemon_int8_rows_equal_the_int8_pipeline(weights, ckpt, sp,
                                                     dtype, stack):
    """``int8_calib=`` under ``mesh_sp``: calibrated once at build, each
    replica's shard on a thread of its own, its scales joined in process;
    the rows, as one batch, are the single int8 pipeline's."""
    _, state = weights
    d, calib = ckpt
    rows = gate_batch(4, L, np.random.default_rng(41))
    kw = dict(int8_stack_layers=tuple(int(i) for i in stack.split(","))
              if stack else None)
    want = make_pipeline(state, {}, dtype=getattr(torch, dtype),
                         device="cpu", max_echoes=8, int8_calib=calib,
                         **kw)(rows).numpy()
    args = {"model_file": "armadillo", "ckpt_dir": str(d), "length": L,
            "device": "cpu", "max_echoes": 8, "max_batch": 4,
            "dtype": dtype, "port": 0, "warmup": False,
            "int8_calib": str(d / "calib.npy"), "mesh": True,
            "mesh_sp": sp}
    if stack:
        args["int8_stack"] = stack
    hostd, server, port = build(args)
    try:
        with ServingClient(("127.0.0.1", port)) as c:
            got = np.asarray(c.infer(rows[:, 0]))
        assert hostd._pipeline.calls == {"int8": 1}  # the first shard's
        shapes = hostd._pipeline.copied["shapes"]
        assert len(shapes) == sp and all(w[-1] < L for (w,) in shapes)
    finally:
        server.shutdown()
        server.server_close()
        hostd.close()
    np.testing.assert_array_equal(got, want)


def test_driver_int8_on_the_sp_mesh(weights, tmp_path):
    """``evaluate=True int8=True`` at dp=1, sp=2 (two gloo ranks) against
    one process and against JAX's driver, from one ``.pth``, on the chirp
    stand-in of ``tests/test_torch_cli_main.py`` (rf 4, L=1600)."""
    root = generate_chirp_dataset(tmp_path / "stof_chirp101_dataset",
                                  n_positions=3, n_train_per_pos=4,
                                  n_test_per_pos=2, sample_num=400)
    variables = JaxStofNet().init(jax.random.key(7),
                                  np.zeros((1, 1, 400 * RF), np.float32))
    runs = {}
    for side in ("jax", "one", "sp"):
        (tmp_path / side).mkdir()
        save_torch_state_dict(params_to_state_dict(variables),
                              str(tmp_path / side / "shared-init.pth"))
        cfg = (jload_config(jmain.DEFAULT_CONFIG) if side == "jax"
               else load_config(pmain.DEFAULT_CONFIG))
        cfg.update(run_dir=str(tmp_path / side / "runs"),
                   ckpt_dir=str(tmp_path / side), data_dir=str(root),
                   batch_size=4, rf_scale_factor=RF, max_echoes=8,
                   plot_interval=0, model="stofnet", evaluate=True,
                   int8=True, th=None, model_file="shared-init")
        if side != "jax":
            cfg.update(device="cpu")
        if side == "sp":
            cfg.update(mesh=True, mesh_sp=2)
        runs[side] = (jmain if side == "jax" else pmain).run(cfg)
    assert not live()
    assert np.isfinite(runs["sp"]["total_distance_mean"])
    _metrics_match(runs["sp"], runs["one"])
    _metrics_match(runs["sp"], runs["jax"])
