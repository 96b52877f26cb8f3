"""The int8 route's exported forward, which joins inside, under sequence
parallelism, on the CPU: its artifact, whose forward is its stages (cut
at each dynamic activation scale, ``models/int8.int8_stages``; the
``max`` joins in the manifest, ``serve.PipelineExport``), written by
``cli/export.py`` with ``int8_calib=`` and served by ``cli/serve.py``
under ``mesh=True mesh_sp=N`` (replicas in one process, each running the
stage programs as its shard, a thread each, the row maxima joined through
``parallel/seq.ThreadExchange``); the layout-2 artifact of it (one
program) still serving whole rows and refused under sp. Zonzini's and
Kuleshov's artifacts: ``tests/test_torch_sp_joined_zoo.py``.

Weights: a JAX ``StofNet().init`` through ``params_to_state_dict``.
Tolerances:
- every row served under sp equals the same artifact's at sp = 1 and the
  daemon's from the checkpoint with the same calibration at the same
  mesh, bit for bit (a max is exact in any order);
- against JAX's int8 pipeline on the same weights and calibration in
  f32, coords within 1 sample (``tests/test_torch_int8.py``'s gate);
- a planted control (each window quantized with its own scale, the
  ``max`` join skipped) misses the heatmap gate, rtol 2e-3, atol 2e-4 *
  max|heatmap|, on a batch whose loud echo lies in one shard.
"""

import io
import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stofnet_tpu.models import StofNet as JaxStofNet
from stofnet_tpu.serve import make_pipeline as jax_make_pipeline
from stofnet_tpu_torch.cli import export as cli_export
from stofnet_tpu_torch.cli.serve import build
from stofnet_tpu_torch.data.synthetic import gate_batch
from stofnet_tpu_torch.models.torch_import import (
    params_to_state_dict, save_torch_state_dict,
)
from stofnet_tpu_torch.parallel import seq
from stofnet_tpu_torch.serve import (
    EXAMPLE_BATCH, MANIFEST, _trace, load_pipeline, make_pipeline,
)
from stofnet_tpu_torch.serving import ServingClient
from tests.test_torch_threads import share_cores

share_cores()  # this xdist worker's share of the cores

L, ECHOES = 800, 8
STACK = ",".join(str(i) for i in range(2, 13))


@pytest.fixture(scope="module")
def int8_src(tmp_path_factory):
    """JAX's random-init StofNet, a ``.pth`` of it and a calibration
    batch on disk."""
    variables = JaxStofNet().init(jax.random.key(0), jnp.zeros((1, 1, L)))
    d = tmp_path_factory.mktemp("joined_int8")
    save_torch_state_dict(params_to_state_dict(variables),
                          str(d / "armadillo-seed0.pth"))
    calib = gate_batch(8, L, np.random.default_rng(40))
    np.save(d / "calib.npy", calib)
    return variables, calib, d


def _int8_args(d, dtype, stack):
    args = {"model_file": "armadillo", "ckpt_dir": str(d), "length": L,
            "device": "cpu", "max_echoes": ECHOES, "dtype": dtype,
            "int8_calib": str(d / "calib.npy")}
    if stack:
        args["int8_stack"] = STACK
    return args


@pytest.fixture(scope="module")
def int8_arts(int8_src):
    """``cli/export.py`` of the int8 route, each (dtype, stack) once."""
    _, _, d = int8_src
    made = {}

    def art(dtype, stack):
        if (dtype, stack) not in made:
            out = d / f"i8-{dtype}-{bool(stack)}.pt2"
            made[dtype, stack] = cli_export.main(
                [f"{k}={v}" for k, v in _int8_args(d, dtype, stack).items()]
                + ["batch=b", f"out={out}"])
        return made[dtype, stack]
    return art


def _serve(args, rows):
    """The daemon of ``args`` on one request of ``rows`` (B, 1, L)."""
    hostd, server, port = build({"port": 0, "warmup": False,
                                 "max_batch": rows.shape[0], **args})
    try:
        with ServingClient(("127.0.0.1", port)) as c:
            return np.asarray(c.infer(rows[:, 0]))
    finally:
        server.shutdown()
        server.server_close()
        hostd.close()


MESHES = {"sp2": dict(mesh_sp=2), "sp4": dict(mesh_sp=4),
          "dp2_sp2": dict(mesh_dp=2, mesh_sp=2)}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("stack", [False, True], ids=["default", "stack"])
def test_int8_artifact_rows_under_sp(int8_src, int8_arts, stack, dtype,
                                     mesh):
    """The int8 artifact (default, and every stack conv in s8) under
    ``mesh_sp`` = 2 and 4 and at dp=2 x sp=2: its stages run as each
    replica's shard, the activation scales joined; every row equals the
    artifact's at sp = 1 and the daemon's from the checkpoint with the
    same ``int8_calib`` on the same mesh."""
    _, _, d = int8_src
    path = int8_arts(dtype, stack)
    served = load_pipeline(path)
    assert served.sp == "joins" and hasattr(served, "shard")
    rows = gate_batch(4, L, np.random.default_rng(41))
    one = served(rows).numpy()
    on = dict(mesh=True, **MESHES[mesh])
    got = _serve({"artifact": str(path), **on}, rows)
    direct = _serve({**_int8_args(d, dtype, stack), **on}, rows)
    np.testing.assert_array_equal(got, one)
    np.testing.assert_array_equal(got, direct)


@pytest.mark.parametrize("stack", [False, True], ids=["default", "stack"])
def test_int8_artifact_under_sp_meets_jax(int8_src, int8_arts, stack):
    """The f32 int8 artifact at ``mesh_sp=2`` against JAX's int8
    pipeline on the same weights and calibration batch: coords within 1
    sample."""
    variables, calib, _ = int8_src
    rows = gate_batch(4, L, np.random.default_rng(42))
    got = _serve({"artifact": str(int8_arts("float32", stack)),
                  "mesh": True, "mesh_sp": 2}, rows)
    kw = {"int8_stack_layers": tuple(range(2, 13))} if stack else {}
    ref = np.asarray(jax_make_pipeline(
        variables, {}, dtype=jnp.float32, int8_calib=jnp.asarray(calib),
        max_echoes=ECHOES, **kw)(jnp.asarray(rows)))
    assert got.shape == ref.shape
    assert np.all(np.abs(got - ref) <= 1.0), np.abs(got - ref).max()


class _Unjoined:
    """An exchange that joins nothing: each window's max is its own."""

    def max(self, t):
        return t


def _assert_heat_close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=2e-3,
                               atol=2e-4 * np.abs(ref).max())


@pytest.mark.parametrize("stack", [False, True], ids=["default", "stack"])
def test_unjoined_artifact_scales_miss(int8_arts, stack):
    """The planted control: the artifact's stages run as each of two
    shards with the ``max`` join skipped, so each window quantizes with
    its own scale. On rows whose loud echo lies in the first shard the
    second shard's codes are finer than the row's and miss the gate;
    joined through a ``ThreadExchange`` the shards give the row's bits."""
    served = load_pipeline(int8_arts("float32", stack))
    x = torch.from_numpy(gate_batch(3, L, np.random.default_rng(9))) * 0.01
    x[..., 100:140] += 1.0  # the loud echo, in shard 0's own samples
    whole = served.heatmap(x)

    def window(k, exchange):
        shard = seq.shard_of(served.arch, L, 2, k, exchange)
        return served.shard(x[..., shard.window[0]:shard.window[1]], shard)
    control = torch.cat([window(k, _Unjoined()) for k in range(2)], -1)
    with pytest.raises(AssertionError):
        _assert_heat_close(control.numpy(), whole.numpy())
    assert torch.equal(torch.cat(seq.run_shards(window, 2), -1), whole)


def layout2_artifact(path, pipe, length, device="cpu"):
    """An artifact as layout 2 wrote one whose forward joins inside: the
    manifest, the forward traced whole as one program (batch-polymorphic)
    and the decode."""
    x = torch.zeros(EXAMPLE_BATCH, 1, length)
    bdim = torch.export.Dim("b", min=1)
    fwd = _trace(pipe.heatmap, (x,), ({0: bdim},))
    dec = _trace(pipe.decode, (pipe.heatmap(x),), ({0: bdim},))
    meta = dict(format=2, length=length, batch="b", input_enc="f32",
                arch=dict(pipe.arch), sp="joins", takes_where=False,
                device=device)
    with zipfile.ZipFile(path, "w") as z:
        z.writestr(MANIFEST, json.dumps(meta))
        for name, program in (("forward", fwd), ("decode", dec)):
            buf = io.BytesIO()
            torch.export.save(program, buf)
            z.writestr(f"{name}.pt2", buf.getvalue())
    return path


def test_layout2_joined_artifact_serves_rows_only(int8_src, tmp_path):
    """A layout-2 int8 artifact (its forward, which joins inside, one
    program) still loads and serves whole rows as the direct pipeline,
    and under ``mesh_sp`` is refused with the message to export it
    again."""
    variables, calib, _ = int8_src
    state = {k: torch.tensor(v)
             for k, v in params_to_state_dict(variables).items()}
    pipe = make_pipeline(state, {}, device="cpu", max_echoes=ECHOES,
                         dtype=torch.float32, int8_calib=calib)
    assert_layout2_rows_only(layout2_artifact(tmp_path / "i8.pt2", pipe, L),
                             pipe, L)


def assert_layout2_rows_only(path, pipe, length):
    """The layout-2 artifact at ``path`` of ``pipe``'s forward serves
    whole rows as ``pipe`` and is refused under ``mesh_sp=2``."""
    served = load_pipeline(path)
    assert (served.format, served.sp) == (2, "joins")
    assert not hasattr(served, "shard")
    rows = gate_batch(2, length, np.random.default_rng(45))
    np.testing.assert_array_equal(_serve({"artifact": str(path)}, rows),
                                  pipe(rows).numpy())
    with pytest.raises(SystemExit, match="joins inside as one program.*"
                                         "export it again"):
        build({"artifact": str(path), "port": 0, "warmup": False,
               "mesh": True, "mesh_sp": 2})
