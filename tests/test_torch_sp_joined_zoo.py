"""Zonzini's and Kuleshov's exported forwards, which join inside, under
sequence parallelism, on the CPU: their artifacts, whose forward is
their stages (``Zonzini.stages``: the features, the f64 ``mean`` join,
the head; ``Kuleshov.stages``: a stage per layer's compute between
``fetch`` joins, the dense head's partial products and their ``sum``
join), written by ``cli/export.py`` (baked and weightless) and served by
``cli/serve.py`` under ``mesh=True mesh_sp=N`` (a thread a replica, the
joins through ``parallel/seq.ThreadExchange``); the layout-2 artifact of
each (one program) still serving whole rows and refused under sp.

Weights: each family's JAX ``init`` through
``registry.variables_to_state_dict``, at ``tests/test_torch_parallel_zoo
.py``'s sizes (Zonzini L=4096, Kuleshov L=800, rf 4). Tolerances: every
row served under sp equals the same artifact's at sp = 1 and the
daemon's from the checkpoint on the same mesh, bit for bit (Zonzini at
dp=2 to rtol 1e-5 against sp = 1, as ``tests/test_torch_cli_mesh_sp.py``:
its dense head runs on half the batch); the sharded stages against JAX's
single device at ``tests/test_torch_parallel_zoo.py``'s rtol 1e-5, atol
1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stofnet_tpu.models import build_model as jbuild
from stofnet_tpu_torch.cli import export as cli_export
from stofnet_tpu_torch.data.synthetic import gate_batch
from stofnet_tpu_torch.models.registry import variables_to_state_dict
from stofnet_tpu_torch.parallel import seq
from stofnet_tpu_torch.serve import load_pipeline, make_pipeline
from stofnet_tpu_torch.train.checkpoint import save_checkpoint
from tests.test_torch_sp_joined_artifact import (
    ECHOES, MESHES, _serve, assert_layout2_rows_only, layout2_artifact,
)
from tests.test_torch_threads import share_cores

share_cores()  # this xdist worker's share of the cores

ZOO_OV = dict(dataset_kind="chirp", upsample_factor=4, rf_scale_factor=4)
ZOO_L = {"zonzini": 4096, "kuleshov": 800}


def _jax_zoo(name):
    """(JAX module, variables) of family ``name`` at its ``ZOO_L``."""
    n = ZOO_L[name]
    jm, _ = jbuild(name, th=None, sample_num=n // 4, fs=1e6, **ZOO_OV)
    return jm, jax.jit(jm.init)(jax.random.key(1), jnp.zeros((1, 1, n)))


@pytest.fixture(scope="module")
def zoo_src(tmp_path_factory):
    """Each joining family's JAX weights as a checkpoint, and its
    ``cli/export.py`` arguments."""
    d = tmp_path_factory.mktemp("joined_zoo")
    out = {}
    for name in ZOO_L:
        jm, variables = _jax_zoo(name)
        state = {k: torch.from_numpy(np.array(v)) for k, v in
                 variables_to_state_dict(name, variables).items()}
        save_checkpoint(d / f"{name}-j.pt", state)
        args = {"model": name, "model_file": f"{name}-j", "ckpt_dir": str(d),
                "length": ZOO_L[name], "device": "cpu", "th": "Null",
                "max_echoes": ECHOES, **ZOO_OV}
        if name == "kuleshov":
            args["sample_num"] = ZOO_L[name] // 4
        out[name] = (jm, variables, args)
    return out, d


def _zoo_art(zoo_src, name, dtype, bake):
    (_, _, args), d = zoo_src[0][name], zoo_src[1]
    out = d / f"{name}-{dtype}-{bake}.pt2"
    if not out.exists():
        cli_export.main([f"{k}={v}" for k, v in args.items()]
                        + ["batch=b", f"out={out}", f"dtype={dtype}",
                           f"bake_weights={bake}"])
    return out


@pytest.mark.parametrize("name,dtype,bake,mesh", [
    ("zonzini", "float32", True, "sp2"), ("zonzini", "float32", True, "sp4"),
    ("zonzini", "float32", False, "sp2"),
    ("zonzini", "float32", False, "sp4"),
    ("zonzini", "float32", True, "dp2_sp2"),
    ("kuleshov", "bfloat16", False, "sp2"),
    ("kuleshov", "float32", True, "sp2"),
], ids=["zonzini_sp2", "zonzini_sp4", "zonzini_weightless_sp2",
        "zonzini_weightless_sp4", "zonzini_dp2_sp2",
        "kuleshov_weightless_bf16", "kuleshov_f32"])
def test_zoo_artifact_rows_under_sp(zoo_src, name, dtype, bake, mesh):
    """Zonzini's (baked and weightless) and Kuleshov's (weightless bf16,
    baked f32) artifacts under ``mesh_sp``: their stages run as each
    replica's shard; every row equals the artifact's at sp = 1 (Zonzini
    at dp=2 to rtol 1e-5) and the daemon's from the checkpoint on the
    same mesh."""
    path = _zoo_art(zoo_src, name, dtype, bake)
    (_, _, args) = zoo_src[0][name]
    served = load_pipeline(path)
    assert served.sp == "joins" and hasattr(served, "shard")
    rows = gate_batch(4, ZOO_L[name], np.random.default_rng(43))
    one = served(rows).numpy()
    on = dict(mesh=True, **MESHES[mesh])
    got = _serve({"artifact": str(path), **on}, rows)
    direct = _serve({**args, "dtype": dtype, **on}, rows)
    np.testing.assert_array_equal(got, direct)
    if "dp2" in mesh:
        np.testing.assert_allclose(got, one, rtol=1e-5)
    else:
        np.testing.assert_array_equal(got, one)


@pytest.mark.parametrize("name", list(ZOO_L))
def test_zoo_artifact_shards_match_jax(zoo_src, name):
    """The f32 artifact's stages as 2 shards (a thread each, joined
    through a ``ThreadExchange``) against JAX's single-device forward of
    the same weights."""
    jm, variables, _ = zoo_src[0][name]
    served = load_pipeline(_zoo_art(zoo_src, name, "float32", True))
    n = ZOO_L[name]
    x = torch.from_numpy(gate_batch(3, n, np.random.default_rng(44)))

    def one(k, exchange):
        shard = seq.shard_of(served.arch, n, 2, k, exchange)
        a, b = shard.window or shard.own
        return served.shard(x[..., a:b], shard)
    outs = seq.run_shards(one, 2)
    got = (torch.cat(outs, -1) if name == "kuleshov" else outs[0]).numpy()
    ref = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x.numpy())))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(ZOO_L))
def test_layout2_joined_artifact_serves_rows_only(zoo_src, tmp_path, name):
    """A layout-2 artifact of Zonzini or Kuleshov (its forward, which
    joins inside, one program) still loads and serves whole rows as the
    direct pipeline, and under ``mesh_sp`` is refused with the message
    to export it again."""
    _, variables, args = zoo_src[0][name]
    state = {k: torch.from_numpy(np.array(v)) for k, v in
             variables_to_state_dict(name, variables).items()}
    ov = {k: args[k] for k in (*ZOO_OV, "sample_num") if k in args}
    pipe = make_pipeline(state, ov, model_name=name, device="cpu",
                         max_echoes=ECHOES, dtype=torch.float32)
    assert_layout2_rows_only(layout2_artifact(
        tmp_path / f"{name}.pt2", pipe, ZOO_L[name]), pipe, ZOO_L[name])
