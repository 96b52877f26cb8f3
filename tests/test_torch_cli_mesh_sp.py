"""``mesh=True mesh_sp=N`` in the port's entry points, on the CPU: the
driver (``cli/main.py``, StofNet on chirp data, train and evaluate) and
the daemon (``cli/serve.py``, replicas in one process), against their
runs without a mesh, and every refusal that stays under sp (JAX's, and
the artifacts of older layouts: export them again).

Each driver run on a mesh starts its own gloo ranks (this process rank
0). Data: the chirp stand-in of ``tests/test_torch_cli_mesh.py`` (rf 4,
L=1600), weights a JAX ``StofNet().init`` through its ``.pth``.
Tolerances: the first train loss rtol 1e-5 (the sharded step's,
``tests/test_torch_parallel_sp.py``), ``val_loss``, ``total_jaccard`` and
``total_distance_mean`` within JAX's 1e-3 relative
(``__graft_entry__.py:104-127``, sharded against single-device
evaluation); daemon rows equal.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from stofnet_tpu.models import StofNet as JaxStofNet
from stofnet_tpu_torch.cli import main as pmain
from stofnet_tpu_torch.cli.serve import build
from stofnet_tpu_torch.data.pala import generate_pala_dataset
from stofnet_tpu_torch.data.synthetic import (
    gate_batch, generate_chirp_dataset,
)
from stofnet_tpu_torch.models.registry import build_model
from stofnet_tpu_torch.models.stofnet import StofNet
from stofnet_tpu_torch.models.torch_import import (
    params_to_state_dict, save_torch_state_dict,
)
from stofnet_tpu_torch.parallel.mesh import live
from stofnet_tpu_torch.scripts import mesh_serve_check
from stofnet_tpu_torch.serve import (
    _trace, encoded_input_specs, export_pipeline, make_pipeline,
    save_pipeline,
)
from stofnet_tpu_torch.serving import ServingClient
from stofnet_tpu_torch.train.checkpoint import save_checkpoint
from stofnet_tpu_torch.utils.config import load_config
from tests.test_torch_sp_joined_artifact import layout2_artifact
from tests.test_torch_threads import share_cores

share_cores()  # this xdist worker's share of the cores

RF = 4
COMMON = dict(batch_size=4, rf_scale_factor=RF, max_echoes=8,
              plot_interval=0, model="stofnet", device="cpu")
SP = dict(mesh=True, mesh_sp=2)
LENGTH, MAX_BATCH = 800, 8
ZOO = ["edsr", "espcn", "zonzini", "unet", "sincnet", "kuleshov", "gradpeak"]


@pytest.fixture(scope="module")
def chirp(tmp_path_factory):
    """The chirp stand-in and a ckpt_dir holding one ``.pth`` of a JAX
    ``StofNet().init``."""
    base = tmp_path_factory.mktemp("mesh_sp")
    root = generate_chirp_dataset(base / "stof_chirp101_dataset",
                                  n_positions=3, n_train_per_pos=4,
                                  n_test_per_pos=2, sample_num=400)
    variables = JaxStofNet().init(jax.random.key(7),
                                  np.zeros((1, 1, 400 * RF), np.float32))
    (base / "ckpts").mkdir()
    save_torch_state_dict(params_to_state_dict(variables),
                          str(base / "ckpts" / "shared-init.pth"))
    return root, base


def _cfg(base, root, **over):
    cfg = load_config(pmain.DEFAULT_CONFIG)
    cfg.update(run_dir=str(base / "runs"), ckpt_dir=str(base / "ckpts"),
               data_dir=str(root), **COMMON)
    cfg.update(over)
    return cfg


def _train_losses(cfg, run_name):
    path = Path(cfg.run_dir) / f"{run_name}.jsonl"
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    return [r["train_loss"] for r in rows if r.get("event") == "train"]


def test_train_on_the_sp_mesh_matches_one_device(chirp):
    """``mesh=True mesh_sp=2``: one epoch, each rank 800 of the 1600
    samples of every row; the losses of the run without a mesh, and the
    checkpoint written by rank 0."""
    root, base = chirp
    over = dict(epochs=1, model_file="shared-init")
    cfg = _cfg(base, root, **over, **SP)
    mesh = pmain.run(cfg)
    one_cfg = _cfg(base, root, **over)
    one = pmain.run(one_cfg)
    assert not live() and Path(mesh["checkpoint"]).is_file()
    got = _train_losses(cfg, mesh["run_name"])
    want = _train_losses(one_cfg, one["run_name"])
    assert len(got) == len(want) >= 2
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert mesh["val_loss"] == pytest.approx(one["val_loss"], rel=1e-3)


@pytest.mark.parametrize("over", [SP, dict(SP, mesh_dp=2)],
                         ids=["sp2", "dp2_sp2"])
def test_evaluate_on_the_sp_mesh_matches_one_device(chirp, over):
    """``evaluate=True`` of one checkpoint on the sp mesh (and dp=2 x
    sp=2) and without one, th=Null (a detection in every row)."""
    root, base = chirp
    ev = dict(evaluate=True, model_file="shared-init", th=None)
    mesh = pmain.run(_cfg(base, root, **ev, **over))
    one = pmain.run(_cfg(base, root, **ev))
    assert np.isfinite(mesh["total_distance_mean"])
    for k in ("val_loss", "total_jaccard", "total_distance_mean"):
        assert mesh[k] == pytest.approx(one[k], rel=1e-3), k


@pytest.mark.parametrize("over,error,match", [
    (dict(evaluate=True, int8=True, mesh_sp=3), Exception,
     "sample length 1600 not divisible by mesh_sp=3"),
    (dict(mesh_sp=3, epochs=1), Exception,
     "sample length 1600 not divisible by mesh_sp=3"),
], ids=["int8", "length"])
def test_driver_sp_refusals(chirp, over, error, match):
    """A length that sp does not divide refused by the ranks as JAX's
    ``_shard_inputs`` refuses it, for the int8 evaluation too, which now
    runs under sp as every route does
    (``tests/test_torch_sp_int8.py``)."""
    root, base = chirp
    with pytest.raises(error, match=match):
        pmain.run(_cfg(base, root, **{**SP, **over}))
    assert not live()


def _metrics_match(mesh, one):
    """``tests/test_cli_e2e.py:241``'s gates of a sharded evaluation
    against one device: the mean distance and the Jaccard index rel 1e-4,
    the loss rel 1e-3."""
    assert mesh["total_distance_mean"] == pytest.approx(
        one["total_distance_mean"], rel=1e-4, abs=1e-5, nan_ok=True)
    assert mesh["total_jaccard"] == pytest.approx(one["total_jaccard"],
                                                  rel=1e-4, nan_ok=True)
    assert mesh["val_loss"] == pytest.approx(one["val_loss"], rel=1e-3)


ESPCN = dict(model="espcn", th=None)
DP_SP = dict(SP, mesh_dp=2)


def test_espcn_evaluates_on_the_dp_sp_mesh_as_one_device(chirp):
    """``tests/test_cli_e2e.py:241``: ESPCN (a fresh seeded draw) on chirp
    data at dp=2 x sp=2 against one device."""
    root, base = chirp
    ev = dict(ESPCN, evaluate=True)
    _metrics_match(pmain.run(_cfg(base, root, **ev, **DP_SP)),
                   pmain.run(_cfg(base, root, **ev)))


def test_espcn_trains_on_the_dp_sp_mesh_as_one_device(chirp):
    """``tests/test_cli_e2e.py:258``: ESPCN trains end to end at dp=2 x
    sp=2; its first loss is the run's without a mesh (rtol 1e-5) and its
    checkpoint is written."""
    root, base = chirp
    over = dict(ESPCN, epochs=1)
    cfg = _cfg(base, root, **over, **DP_SP)
    mesh = pmain.run(cfg)
    one_cfg = _cfg(base, root, **over)
    one = pmain.run(one_cfg)
    assert np.isfinite(mesh["val_loss"]) and Path(
        mesh["checkpoint"]).is_file()
    np.testing.assert_allclose(_train_losses(cfg, mesh["run_name"])[0],
                               _train_losses(one_cfg, one["run_name"])[0],
                               rtol=1e-5)
    assert mesh["val_loss"] == pytest.approx(one["val_loss"], rel=1e-3)


@pytest.mark.parametrize("kind,over", [
    ("pala", dict(DP_SP, sequences=[0, 1], ch_gap=16, etol=400)),
    ("rat", dict(SP, sequences=[0, 1], ch_gap=16, etol=400)),
], ids=["pala_dp2_sp2", "rat_sp2"])
def test_pala_evaluates_on_the_sp_mesh_as_one_device(tmp_path, kind, over):
    """``tests/test_cli_e2e.py:330``: ESPCN on the channel-flattened PALA
    batch (per-channel multi-target GT, ``ch_gap``) at dp=2 x sp=2, and on
    rat data at sp=2, against one device."""
    root = generate_pala_dataset(tmp_path / f"{kind}_synth", n_sequences=2,
                                 n_frames=3, n_channels=32, n_samples=100)
    common = dict(ESPCN, evaluate=True, rf_scale_factor=2, batch_size=2,
                  **{k: v for k, v in over.items() if k not in DP_SP})
    mesh_over = {k: v for k, v in over.items() if k in DP_SP}
    _metrics_match(pmain.run(_cfg(tmp_path / "m", root, **common,
                                  **mesh_over)),
                   pmain.run(_cfg(tmp_path / "s", root, **common)))


def test_pala_trains_on_the_sp_mesh_as_one_device(tmp_path):
    """ESPCN trains one epoch on the channel-flattened PALA batch at
    dp=2 x sp=2: its first loss is the run's without a mesh (rtol 1e-5),
    its validation loss rel 1e-3."""
    root = generate_pala_dataset(tmp_path / "pala_synth", n_sequences=2,
                                 n_frames=6, n_channels=32, n_samples=100)
    over = dict(ESPCN, epochs=1, rf_scale_factor=2, batch_size=2,
                sequences=[0, 1], ch_gap=16)
    cfg = _cfg(tmp_path / "m", root, **over, **DP_SP)
    mesh = pmain.run(cfg)
    one_cfg = _cfg(tmp_path / "s", root, **over)
    one = pmain.run(one_cfg)
    np.testing.assert_allclose(_train_losses(cfg, mesh["run_name"])[0],
                               _train_losses(one_cfg, one["run_name"])[0],
                               rtol=1e-5)
    assert mesh["val_loss"] == pytest.approx(one["val_loss"], rel=1e-3)


@pytest.mark.parametrize("name", ["edsr", "zonzini", "unet", "sincnet",
                                  "kuleshov", "gradpeak"])
def test_zoo_runs_on_the_sp_mesh_as_one_device(chirp, name):
    """Every other family through the driver at sp=2 against one device:
    one epoch of training (the first loss rtol 1e-5, the validation loss
    rel 1e-3; at L=1600 Zonzini's second shard holds none of the last
    stage's 3 positions), GradPeak's evaluation by the metrics' gates.
    Kuleshov's validation loss rel 1e-2: its up convs' biases feed a
    BatchNorm, so their gradients are rounding noise, which AdamW's steps
    turn into updates of up to lr either way (the sharded step holds its
    gradients, ``tests/test_torch_parallel_zoo.py``)."""
    root, base = chirp
    over = dict(model=name, th=None)
    if name == "gradpeak":
        _metrics_match(pmain.run(_cfg(base, root, **over, **SP)),
                       pmain.run(_cfg(base, root, **over)))
        return
    over["epochs"] = 1
    cfg = _cfg(base, root, **over, **SP)
    mesh = pmain.run(cfg)
    one_cfg = _cfg(base, root, **over)
    one = pmain.run(one_cfg)
    np.testing.assert_allclose(_train_losses(cfg, mesh["run_name"])[0],
                               _train_losses(one_cfg, one["run_name"])[0],
                               rtol=1e-5)
    assert mesh["val_loss"] == pytest.approx(
        one["val_loss"], rel=1e-2 if name == "kuleshov" else 1e-3)


# ---- the daemon ----------------------------------------------------------

@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A seeded StofNet's checkpoint and its artifact, 6 echo rows."""
    d = tmp_path_factory.mktemp("mesh_sp_daemon")
    state = StofNet(generator=torch.Generator().manual_seed(0),
                    device="cpu").state_dict()
    save_checkpoint(d / "armadillo-seed0.pt", state)
    art = save_pipeline(d / "b.pt2", export_pipeline(
        state, {"upsample_factor": 4}, "b", LENGTH, device="cpu",
        max_echoes=8))
    return d, state, art, gate_batch(6, LENGTH, np.random.default_rng(5))


def _args(d, **kw):
    args = {"model_file": "armadillo", "ckpt_dir": str(d), "length": LENGTH,
            "device": "cpu", "max_echoes": 8, "max_batch": MAX_BATCH,
            "max_wait_ms": 2, "port": 0, **SP}
    args.update(kw)
    return args


@pytest.mark.parametrize("dtype,length,mesh_dp", [
    ("float32", LENGTH, 1), ("bfloat16", LENGTH, 1), ("float32", LENGTH, 2),
    ("float32", 1000, 1),
], ids=["f32", "bf16", "dp2", "module_route"])
def test_sp_daemon_rows_equal_the_direct_pipeline(served, dtype, length,
                                                  mesh_dp):
    """The daemon at sp=2 (and dp=2 x sp=2: four replicas) answers every
    row, one at a time and as one batch, as ``make_pipeline``'s direct
    coords; at L=1000 (L % 80 = 40) every shard takes the module route."""
    d, state, _, _ = served
    rows = gate_batch(6, length, np.random.default_rng(length))
    dt = getattr(torch, dtype)
    pipe = make_pipeline(state, {"upsample_factor": 4}, dtype=dt,
                         device="cpu", max_echoes=8)
    want = pipe(rows).numpy()
    hostd, server, port = build(_args(d, dtype=dtype, length=length,
                                      mesh_dp=mesh_dp))
    try:
        with ServingClient(("127.0.0.1", port)) as c:
            got = np.stack([c.infer(r) for r in rows[:, 0]])
            whole = np.asarray(c.infer(rows[:, 0]))
        route = "fused" if length % 80 == 0 else "module"
        assert hostd._pipeline.calls[route] >= 1
        assert hostd._pipeline.route(length) == route
    finally:
        server.shutdown()
        server.server_close()
        hostd.close()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(whole, want)


@pytest.mark.parametrize("over,match", [
    (dict(mesh_sp=3), "sample length 800 not divisible by mesh_sp=3"),
    (dict(mesh_sp=4, input_enc="s8c6"), "input_enc=s8c6 under mesh_sp=4.*"
     "sp must divide the chunk count 6"),
    (dict(artifact="int8"), "joins inside as one program.*export it again"),
    (dict(artifact="one program"), "one program.*export it again"),
], ids=["length", "input_enc", "int8", "artifact"])
def test_sp_daemon_refusals(served, over, match, tmp_path):
    """JAX's refusals of a length sp does not divide and of s8c chunks sp
    does not divide; an int8 artifact of layout 2, whose forward, which
    joins inside, is one program (the int8 artifacts of this layout, its
    stages, serve under sp: ``tests/test_torch_sp_joined_artifact.py``);
    an artifact of one program (the layout before the forward and the
    decode were exported apart), which decodes whole rows; both are
    exported again to serve under sp."""
    d, state, _, _ = served
    args = _args(d, **over)
    if over.get("artifact") == "int8":
        art = layout2_artifact(tmp_path / "i8.pt2", make_pipeline(
            state, {"upsample_factor": 4}, device="cpu", max_echoes=8,
            int8_calib=gate_batch(4, LENGTH, np.random.default_rng(1))),
            LENGTH)
        args = {"artifact": str(art), "port": 0, **SP}
    elif over.get("artifact"):
        args = {"artifact": str(one_program_artifact(
            tmp_path / "one.pt2", state, LENGTH)), "port": 0, **SP}
    with pytest.raises(SystemExit, match=match):
        build(args)


def one_program_artifact(path, state, length, **kw):
    """An artifact as the exporter wrote it before the forward and the
    decode were exported apart: ``torch.export.save`` of one program of
    the whole pipeline, batch-polymorphic, on the CPU."""
    pipe = make_pipeline(state, {"upsample_factor": 4}, device="cpu",
                         max_echoes=8, **kw)
    examples, dynamic = encoded_input_specs(kw.get("input_enc"), "b",
                                            length)
    torch.export.save(_trace(pipe, examples, dynamic), str(path))
    return path


@pytest.fixture(scope="module")
def zoo_served(tmp_path_factory):
    """A checkpoint of a seeded draw of each zoo family at L=1024 (fs 1
    MHz, Kuleshov's input the row: sample_num 256 at rf 4)."""
    d = tmp_path_factory.mktemp("mesh_sp_zoo")
    for name in ZOO[:-1]:
        model, _ = build_model(name, generator=torch.Generator()
                               .manual_seed(1), device="cpu", **ZOO_ARGS)
        save_checkpoint(d / f"{name}-seed1.pt", model.state_dict())
    return d


ZOO_ARGS = dict(dataset_kind="chirp", upsample_factor=4, rf_scale_factor=4,
                sample_num=256, fs=1e6)


@pytest.mark.parametrize("name,dtype", [
    *[(n, "float32") for n in ZOO], ("unet", "bfloat16"),
    ("kuleshov", "bfloat16")])
def test_sp_daemon_zoo_rows_equal_the_direct_pipeline(zoo_served, name,
                                                       dtype):
    """``model=<family> mesh_sp=2`` (and Zonzini and the unet at dp=2 x
    sp=2): the replicas of a dp row run the family's forward on their
    windows (Zonzini and Kuleshov their shard form, a thread each, every
    dp row at once) and the first joins and decodes; every row of a batch
    as ``make_pipeline``'s direct rows (equal; Zonzini's regression within
    rtol 1e-5: at dp=2 its dense head runs on half the batch)."""
    length = 1024
    args = {"model": name, "ckpt_dir": str(zoo_served), "length": length,
            "device": "cpu", "max_echoes": 8, "max_batch": 4, "port": 0,
            "warmup": False, "dtype": dtype, "th": "Null", **ZOO_ARGS, **SP}
    if name != "gradpeak":
        args["model_file"] = f"{name}-seed1"
    if name in ("zonzini", "unet") and dtype == "float32":
        args["mesh_dp"] = 2
    state = ({} if name == "gradpeak" else
             torch.load(zoo_served / f"{name}-seed1.pt")["model"])
    overrides = {k: v for k, v in ZOO_ARGS.items()
                 if k != "sample_num" or name == "kuleshov"}
    if name == "unet":
        overrides["n_layers"] = 2
    pipe = make_pipeline(state, overrides, model_name=name,
                         dtype=getattr(torch, dtype), device="cpu",
                         max_echoes=8)
    rows = gate_batch(4, length, np.random.default_rng(3))
    want = pipe(rows).numpy()
    hostd, server, port = build(args)
    try:
        with ServingClient(("127.0.0.1", port)) as c:
            got = np.asarray(c.infer(rows[:, 0]))
    finally:
        server.shutdown()
        server.server_close()
        hostd.close()
    if name == "zonzini":
        np.testing.assert_allclose(got, want, rtol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


def test_mesh_serve_check_rows_agree_across_sp(capsys):
    """``scripts/mesh_serve_check.py --sp 1 2`` on the CPU: the daemon at
    sp=1 and sp=2 answers a whole batch with the same rows."""
    assert mesh_serve_check.main(["--device", "cpu", "--dp", "1", "--sp",
                                  "1", "2", "--length", "800", "--batch",
                                  "4", "--requests", "1"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [(x["dp"], x["sp"]) for x in lines] == [(1, 1), (1, 2)]
    assert all(x["rows_equal_first"] for x in lines)


def test_mesh_serve_check_takes_the_zoo(capsys):
    """``scripts/mesh_serve_check.py --model zonzini kuleshov --sp 1 2`` on
    the CPU: each family's daemon at sp=1 and sp=2 answers a batch with
    the same rows (Zonzini's ToA within ``ZONZINI_RTOL``)."""
    assert mesh_serve_check.main([
        "--device", "cpu", "--dp", "1", "--sp", "1", "2", "--length",
        "1024", "--batch", "4", "--requests", "1", "--model", "zonzini",
        "kuleshov"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [(x["model"], x["sp"]) for x in lines] == [
        ("zonzini", 1), ("zonzini", 2), ("kuleshov", 1), ("kuleshov", 2)]
    assert all(x["agreement_first"] == 1.0 for x in lines)


def test_dp_check_takes_the_zoo(capsys):
    """``scripts/dp_check.py --model unet gradpeak --dp 1 --sp 2`` (two
    gloo ranks): the unet's f32 step and GradPeak's rows at sp=2 against
    the single process."""
    from stofnet_tpu_torch.scripts import dp_check

    dp_check.main(["--device", "cpu", "--dp", "1", "--sp", "2", "--length",
                   "1024", "--batch", "4", "--model", "unet", "gradpeak"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["model"] for x in lines] == ["unet", "gradpeak"]
    np.testing.assert_allclose(lines[0]["dp_loss"], lines[0]["loss"],
                               rtol=1e-5)
    assert lines[0]["ranks_equal"] and lines[0]["params_max_diff"] < 1e-3
    assert lines[1]["rows_equal"]


def test_array_keeps_refusing_sp(chirp):
    """JAX's job array refuses mesh_sp > 1 (``stofnet_tpu/cli/array.py``),
    and so does the port's, after the sp axis."""
    from stofnet_tpu_torch.cli import array as parray

    root, base = chirp
    with pytest.raises(ValueError, match="mesh_sp must be 1"):
        parray.run(_cfg(base, root, seeds=2, epochs=1, **SP))


def test_sp_check_script_on_the_cpu(capsys):
    """``scripts/dp_check.py --dp 1 --sp 2`` (two gloo ranks): the f32 and
    amp StofNet steps of the sp mesh against the single process."""
    from stofnet_tpu_torch.scripts import dp_check

    dp_check.main(["--device", "cpu", "--dp", "1", "--sp", "2",
                   "--length", "640", "--batch", "4"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["model"] for x in lines] == ["stofnet", "stofnet amp"]
    for x in lines:
        assert x["sp"] == 2 and x["ranks_equal"]
        np.testing.assert_allclose(x["dp_loss"], x["loss"],
                                   rtol=1e-5 if x["model"] == "stofnet"
                                   else 1e-2)
        assert x["params_max_diff"] < 1e-3
