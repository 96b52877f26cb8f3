"""Artifacts and encoded inputs under sequence parallelism, on the CPU:
the artifact's forward and decode exported apart (``serve.
PipelineExport``), served by ``cli/serve.py`` under ``mesh=True
mesh_sp=N`` (replicas in one process, each running the forward program
on its window), the zoo's artifacts, ``input_enc=`` with ``model_file=``
and with ``artifact=`` (each replica copies only its window's codes),
Zonzini's and Kuleshov's artifacts, whose forward joins inside (their
stages, each replica's shard on a thread), the refusals that stay (an
older layout of such an artifact: export it again; JAX's s8c rule) and
``scripts/mesh_serve_check.py``'s new routes.

Weights: a JAX ``StofNet().init`` through ``params_to_state_dict``; the
zoo's seeded draws at ``tests/test_torch_cli_mesh_sp.py``'s arguments.
Tolerances: every sharded route's rows equal the same route's rows at
sp = 1 (the windows compute the row's arithmetic), and an artifact of
two programs gives the rows of the one program written before; against
JAX's f32 pipeline, JAX's sp gate (``__graft_entry__.py:188-208``):
coords within 1 sample on >= 0.99 of the slots.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stofnet_tpu.models import StofNet as JaxStofNet
from stofnet_tpu.serve import make_pipeline as jax_make_pipeline
from stofnet_tpu_torch.cli.serve import build
from stofnet_tpu_torch.data.synthetic import gate_batch
from stofnet_tpu_torch.models.registry import build_model
from stofnet_tpu_torch.models.torch_import import params_to_state_dict
from stofnet_tpu_torch.parallel import seq
from stofnet_tpu_torch.scripts import mesh_serve_check
from stofnet_tpu_torch.serve import (
    export_pipeline, export_pipeline_weightless, load_pipeline,
    make_pipeline, save_pipeline,
)
from stofnet_tpu_torch.serving import ServingClient
from stofnet_tpu_torch.train.checkpoint import save_checkpoint
from tests.test_torch_cli_mesh_sp import one_program_artifact
from tests.test_torch_sp_joined_artifact import layout2_artifact

L, L_MODULE = 800, 1000  # the fused route, and L % 80 != 0: the module's
OV = {"upsample_factor": 4}
KW = dict(device="cpu", max_echoes=8)
ZOO_ARGS = dict(dataset_kind="chirp", upsample_factor=4, rf_scale_factor=4,
                sample_num=256, fs=1e6)
ZOO_L = 1024


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """JAX's random-init StofNet, the same weights as a torch state dict,
    and a checkpoint of them."""
    variables = JaxStofNet().init(jax.random.key(0), jnp.zeros((1, 1, L)))
    state = {k: torch.tensor(v)
             for k, v in params_to_state_dict(variables).items()}
    d = tmp_path_factory.mktemp("sp_art")
    save_checkpoint(d / "armadillo-seed0.pt", state)
    return variables, state, d


def _rows(length=L, seed=0, batch=4):
    return gate_batch(batch, length, np.random.default_rng(seed))


def _serve(args, rows):
    """The daemon of ``args`` on one request of ``rows``: its coords and
    what its replicas were copied."""
    hostd, server, port = build({"port": 0, "warmup": False,
                                 "max_batch": rows.shape[0], **args})
    try:
        with ServingClient(("127.0.0.1", port)) as c:
            got = np.asarray(c.infer(rows[:, 0]))
        return got, hostd._pipeline.copied
    finally:
        server.shutdown()
        server.server_close()
        hostd.close()


def _sp(sp):
    return {"mesh": True, "mesh_sp": sp}


def _windows_only(copied, length, sp, arch=None):
    """Every copy a window's: sp copies a request, each the length of its
    shard's window by the family's rule (``parallel/seq.windows``; StofNet
    when ``arch`` is None), none of the row's where the reach is shorter
    than the row."""
    shapes = copied["shapes"]
    want = [b - a for (a, b), _ in seq.windows(length, sp, arch or {})]
    assert [s[0][-1] for s in shapes] == want
    if arch is None or arch["family"] != "sincnet":
        assert max(want) < length


@pytest.mark.parametrize("length", [L, L_MODULE], ids=["fused", "module"])
def test_two_programs_give_the_one_programs_rows(weights, tmp_path, length):
    """At sp = 1 the artifact's ``decode(forward(x))`` gives the rows of
    the one program written before the two were exported apart, which
    still loads and serves (``sp`` None); the forward also takes a
    window of another length on its grid."""
    _, state, _ = weights
    new = load_pipeline(save_pipeline(tmp_path / "two.pt2", export_pipeline(
        state, OV, "b", length, **KW)))
    old = load_pipeline(one_program_artifact(tmp_path / "one.pt2", state,
                                             length))
    assert (new.sp, old.sp) == ("windows", None)
    x = _rows(length, seed=1, batch=3)
    want = make_pipeline(state, OV, **KW)(x)
    assert torch.equal(old(x), want)
    assert torch.equal(new(x), want)
    assert torch.equal(new.decode(new.heatmap(torch.from_numpy(x))), want)
    assert new.heatmap(torch.from_numpy(x[..., 160:])).shape == (
        3, 1, 4 * (length - 160))


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("bake", [True, False], ids=["baked", "weightless"])
def test_artifact_rows_under_sp_equal_sp1(weights, tmp_path, bake, sp):
    """``artifact=`` under ``mesh_sp`` = 2 and 4, baked and weightless:
    each replica runs the forward program on its window (no copy holds
    the row) and the rows equal the artifact's at sp = 1."""
    _, state, _ = weights
    path = tmp_path / "a.pt2"
    if bake:
        save_pipeline(path, export_pipeline(state, OV, "b", L, **KW))
    else:
        art, side = export_pipeline_weightless(state, OV, "b", L, **KW)
        save_pipeline(path, art, weights=side)
    rows = _rows(seed=2)
    want = load_pipeline(path)(rows).numpy()
    got, copied = _serve({"artifact": str(path), **_sp(sp)}, rows)
    np.testing.assert_array_equal(got, want)
    _windows_only(copied, L, sp)


def test_artifact_under_sp_meets_jax_gate(weights, tmp_path):
    """The f32 artifact at ``mesh_sp=2`` against JAX's f32 pipeline on
    the same weights: JAX's own gate of sharded against single-device
    serving."""
    variables, state, _ = weights
    path = save_pipeline(tmp_path / "f32.pt2", export_pipeline(
        state, OV, "b", L, dtype=torch.float32, **KW))
    rows = _rows(seed=3)
    got, _ = _serve({"artifact": str(path), **_sp(2)}, rows)
    ref = np.asarray(jax_make_pipeline(variables, {}, dtype=jnp.float32,
                                       max_echoes=8)(jnp.asarray(rows)))
    assert np.mean(np.abs(got - ref) <= 1.0) >= 0.99


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    """A seeded draw of each zoo family's state, and its overrides."""
    out = {}
    for name in ("espcn", "edsr", "sincnet", "unet", "gradpeak", "zonzini",
                 "kuleshov"):
        kw = dict(ZOO_ARGS)
        if name == "unet":
            kw["n_layers"] = 2
        model, _ = build_model(name, generator=torch.Generator()
                               .manual_seed(1), device="cpu", **kw)
        if name != "kuleshov":
            kw.pop("sample_num")
        out[name] = (model.state_dict(), kw)
    return out


@pytest.mark.parametrize("name,sp,bake", [
    ("espcn", 2, True), ("edsr", 2, True), ("sincnet", 2, True),
    ("unet", 2, True), ("unet", 4, True), ("unet", 2, False),
    ("gradpeak", 2, True),
], ids=["espcn", "edsr", "sincnet", "unet", "unet_sp4", "unet_weightless",
        "gradpeak"])
def test_zoo_artifact_rows_under_sp_equal_sp1(zoo, tmp_path, name, sp,
                                              bake):
    """The windowed families' artifacts (the Wave-U-Net's forward takes
    its window's place) and GradPeak's, whose forward runs on the row:
    rows under ``mesh_sp`` equal the artifact's at sp = 1."""
    state, ov = zoo[name]
    path = tmp_path / f"{name}.pt2"
    kw = dict(model_name=name, dtype=torch.float32, **KW)
    if bake:
        save_pipeline(path, export_pipeline(state, ov, "b", ZOO_L, **kw))
    else:
        art, side = export_pipeline_weightless(state, ov, "b", ZOO_L, **kw)
        save_pipeline(path, art, weights=side)
    rows = _rows(ZOO_L, seed=4)
    served = load_pipeline(path)
    assert served.sp == ("row" if name == "gradpeak" else "windows")
    want = served(rows).numpy()
    got, copied = _serve({"artifact": str(path), **_sp(sp)}, rows)
    np.testing.assert_array_equal(got, want)
    if name != "gradpeak":  # SincNet's reach, 523, spans half the row
        _windows_only(copied, ZOO_L, sp, served.arch)


@pytest.mark.parametrize("name", ["zonzini", "kuleshov"])
def test_joined_zoo_artifacts_refuse_sp(zoo, tmp_path, name):
    """Zonzini's and Kuleshov's forwards join inside: their artifacts
    (the forward's stages) serve at sp = 1 and under ``mesh_sp=2`` with
    the rows of the direct pipeline (each replica's stages as its shard,
    a thread each, each Kuleshov replica copied only its own samples);
    only the layout-2 artifact of such a forward, one program, is
    refused under sp, to be exported again."""
    state, ov = zoo[name]
    kw = dict(model_name=name, dtype=torch.float32, **KW)
    path = save_pipeline(tmp_path / f"{name}.pt2", export_pipeline(
        state, ov, "b", ZOO_L, **kw))
    rows = _rows(ZOO_L, seed=5, batch=2)
    assert load_pipeline(path).sp == "joins"
    want = make_pipeline(state, ov, **kw)(rows).numpy()
    got, _ = _serve({"artifact": str(path)}, rows)
    np.testing.assert_array_equal(got, want)
    got, copied = _serve({"artifact": str(path), **_sp(2)}, rows)
    np.testing.assert_array_equal(got, want)
    if name == "kuleshov":
        assert [s[0][-1] for s in copied["shapes"]] == [ZOO_L // 2] * 2
    old = layout2_artifact(tmp_path / f"{name}-2.pt2",
                           make_pipeline(state, ov, **kw), ZOO_L)
    with pytest.raises(SystemExit, match="joins inside as one program.*"
                                         "export it again"):
        build({"artifact": str(old), "port": 0, "warmup": False,
               **_sp(2)})


@pytest.mark.parametrize("source", ["model_file", "artifact"])
@pytest.mark.parametrize("enc", ["bf16", "s16", "s8c16"])
def test_encoded_inputs_under_sp_equal_sp1(weights, tmp_path, enc, source):
    """``input_enc=`` at ``mesh_sp=2``, from a checkpoint and from an
    encoded artifact: the rows are the sp=1 encoded daemon's, and each
    replica is copied its window's codes and the scales they need (the
    row's s16 scale, the s8c chunks its window touches), never the
    row's."""
    _, state, d = weights
    if source == "artifact":
        path = save_pipeline(tmp_path / f"{enc}.pt2", export_pipeline(
            state, OV, "b", L, input_enc=enc, **KW))
        args = {"artifact": str(path)}
    else:
        args = {"model_file": "armadillo", "ckpt_dir": str(d), "length": L,
                "device": "cpu", "max_echoes": 8, "dtype": "bfloat16",
                "input_enc": enc}
    rows = _rows(seed=6)
    want, one = _serve(args, rows)
    got, copied = _serve({**args, **_sp(2)}, rows)
    np.testing.assert_array_equal(got, want)
    _windows_only(copied, L, 2)
    assert copied["bytes"] < 2 * one["bytes"]
    if enc == "s8c16":
        assert all(s[1][-1] < 16 for s in copied["shapes"])
    if enc == "s16":
        assert all(s[1] == (4, 1, 1) for s in copied["shapes"])


@pytest.mark.parametrize("source", ["model_file", "artifact"])
def test_s8c_chunks_that_sp_does_not_divide_are_refused(weights, tmp_path,
                                                        source):
    """JAX's jit refuses an s8c chunk count that sp does not divide (its
    chunk scales shard over sp): s8c10 at sp = 4, refused at build; sp=2
    divides it and serves."""
    _, state, d = weights
    if source == "artifact":
        path = save_pipeline(tmp_path / "s8c10.pt2", export_pipeline(
            state, OV, "b", L, input_enc="s8c10", **KW))
        args = {"artifact": str(path)}
    else:
        args = {"model_file": "armadillo", "ckpt_dir": str(d), "length": L,
                "device": "cpu", "max_echoes": 8, "dtype": "bfloat16",
                "input_enc": "s8c10"}
    with pytest.raises(SystemExit, match="s8c10 under mesh_sp=4.*chunk "
                                         "count 10"):
        build({**args, "port": 0, "warmup": False, **_sp(4)})
    rows = _rows(seed=7)
    np.testing.assert_array_equal(_serve({**args, **_sp(2)}, rows)[0],
                                  _serve(args, rows)[0])


@pytest.mark.parametrize("flags", [
    ["--artifact"], ["--input-enc", "s16", "s8c16"],
    ["--artifact", "--input-enc", "s8c16"],
    ["--int8", "--int8-stack", "4", "8"],
    ["--artifact", "--int8"],
    ["--artifact", "--model", "zonzini", "kuleshov", "--length", "1024"],
], ids=["artifact", "input_enc", "encoded_artifact", "int8", "int8_artifact",
        "joined_zoo_artifacts"])
def test_mesh_serve_check_new_routes(capsys, flags):
    """``scripts/mesh_serve_check.py`` with its new flags on the CPU:
    each route's rows at sp = 2 equal its rows at sp = 1 (the int8,
    Zonzini and Kuleshov artifacts too, whose forward joins inside)."""
    assert mesh_serve_check.main(
        ["--device", "cpu", "--dp", "1", "--sp", "1", "2", "--length",
         str(L), "--batch", "4", "--requests", "1", *flags]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()
             if s.startswith("{")]
    assert lines and all(r["rows_equal_first"] for r in lines)
    assert {r["sp"] for r in lines} == {1, 2}
    assert all(r["bytes_per_request"] > 0 for r in lines)
