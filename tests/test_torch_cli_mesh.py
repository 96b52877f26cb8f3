"""``mesh=True`` in the port's entry points, on the CPU: the driver
(``cli/main.py``), the job array (``cli/array.py``), the daemon
(``cli/serve.py``) and the multi-process demo
(``scripts/multihost_demo.py``), against their single-device runs and
JAX's driver.

Each driver run on a mesh starts its own 2 gloo ranks (this process rank
0); the daemon's mesh is replicas in one process. Data: the chirp
stand-in of ``tests/test_torch_cli_main.py`` (at rf 4, L=1600) and a
PALA set of ``tests/test_torch_cli_main_pala.py``'s size. Tolerances, as
``tests/test_cli_e2e.py:241,258,330`` hold JAX's mesh runs against one
device: ``total_distance_mean`` rel 1e-4 and abs 1e-5,
``total_jaccard`` rel 1e-4, ``val_loss`` rel 1e-3; against JAX's driver,
``tests/test_torch_cli_main.py``'s (``val_loss`` rtol 1e-4, decoded
metrics up to 1e-6); train losses rtol 1e-5 and member losses rtol 1e-5,
atol 1e-6 (the dp step's, ``tests/test_torch_parallel.py``); daemon rows
equal.
"""

import json
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from stofnet_tpu.cli import main as jmain
from stofnet_tpu.data.synthetic import generate_chirp_dataset
from stofnet_tpu.models import StofNet as JaxStofNet
from stofnet_tpu.utils.config import load_config as jload_config
from stofnet_tpu_torch.cli import array as parray
from stofnet_tpu_torch.cli import main as pmain
from stofnet_tpu_torch.cli.serve import build
from stofnet_tpu_torch.data.pala import generate_pala_dataset
from stofnet_tpu_torch.data.synthetic import gate_batch
from stofnet_tpu_torch.models.stofnet import StofNet
from stofnet_tpu_torch.models.torch_import import (
    params_to_state_dict, save_torch_state_dict,
)
from stofnet_tpu_torch.parallel.mesh import live
from stofnet_tpu_torch.scripts import mesh_serve_check, multihost_demo
from stofnet_tpu_torch.serve import export_pipeline, save_pipeline
from stofnet_tpu_torch.serving import ServingClient
from stofnet_tpu_torch.train.checkpoint import save_checkpoint
from stofnet_tpu_torch.utils.config import load_config
from tests.test_torch_threads import share_cores

share_cores()  # this xdist worker's share of the cores

RF = 4
COMMON = dict(batch_size=4, rf_scale_factor=RF, max_echoes=8,
              plot_interval=0, model="stofnet")
MESH = dict(mesh=True, mesh_dp=2)
LENGTH, MAX_BATCH = 800, 8


@pytest.fixture(scope="module")
def chirp(tmp_path_factory):
    """The chirp stand-in and one ckpt_dir a driver, each holding one
    ``.pth`` of a JAX ``StofNet().init``."""
    base = tmp_path_factory.mktemp("mesh")
    root = generate_chirp_dataset(base / "stof_chirp101_dataset",
                                  n_positions=3, n_train_per_pos=4,
                                  n_test_per_pos=2, sample_num=400)
    variables = JaxStofNet().init(jax.random.key(7),
                                  np.zeros((1, 1, 400 * RF), np.float32))
    pth = base / "shared-init.pth"
    save_torch_state_dict(params_to_state_dict(variables), str(pth))
    dirs = {}
    for side in ("jax", "port"):
        (base / side / "ckpts").mkdir(parents=True)
        shutil.copy(pth, base / side / "ckpts" / pth.name)
        dirs[side] = base / side
    return root, dirs


def _cfg(side, d, root, **over):
    cfg = (jload_config(jmain.DEFAULT_CONFIG) if side == "jax"
           else load_config(pmain.DEFAULT_CONFIG))
    cfg.update(run_dir=str(d / "runs"), ckpt_dir=str(d / "ckpts"),
               data_dir=str(root), **COMMON)
    if side == "port":
        cfg.update(device="cpu")
    cfg.update(over)
    return cfg


def _events(cfg, run_name, kind):
    path = Path(cfg.run_dir) / f"{run_name}.jsonl"
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    return [r for r in rows if r.get("event") == kind]


def _assert_summary(got, want, rel_metric=1e-4, abs_metric=1e-5,
                    rel_loss=1e-3):
    assert got["total_distance_mean"] == pytest.approx(
        want["total_distance_mean"], rel=rel_metric, abs=abs_metric,
        nan_ok=True)
    assert got["total_jaccard"] == pytest.approx(
        want["total_jaccard"], rel=rel_metric, nan_ok=True)
    assert got["val_loss"] == pytest.approx(want["val_loss"], rel=rel_loss)


def test_evaluate_on_the_mesh_matches_one_device_and_jax(chirp):
    """tests/test_cli_e2e.py:241: ``evaluate=True mesh=True mesh_dp=2``
    against the port's single-device run and JAX's driver, from one
    ``.pth``, with a detection in every row (th=Null)."""
    root, dirs = chirp
    over = dict(evaluate=True, model_file="shared-init", th=None)
    mesh = pmain.run(_cfg("port", dirs["port"], root, **over, **MESH))
    one = pmain.run(_cfg("port", dirs["port"], root, **over))
    jx = jmain.run(_cfg("jax", dirs["jax"], root, **over))
    assert not live()
    assert np.isfinite(mesh["total_distance_mean"])
    _assert_summary(mesh, one)
    _assert_summary(mesh, jx, rel_metric=0.0, abs_metric=1e-6,
                    rel_loss=1e-4)


def test_train_on_the_mesh_matches_one_device(chirp):
    """tests/test_cli_e2e.py:258: one epoch on the mesh writes its
    checkpoint (rank 0) and logs the global batch's losses, those of the
    single-device run."""
    root, dirs = chirp
    over = dict(epochs=1, model_file="shared-init")
    cfg = _cfg("port", dirs["port"], root, **over, **MESH)
    mesh = pmain.run(cfg)
    one_cfg = _cfg("port", dirs["port"], root, **over)
    one = pmain.run(one_cfg)
    assert np.isfinite(mesh["val_loss"])
    assert Path(mesh["checkpoint"]).is_file()
    got = [e["train_loss"] for e in _events(cfg, mesh["run_name"], "train")]
    want = [e["train_loss"]
            for e in _events(one_cfg, one["run_name"], "train")]
    assert len(got) == len(want) >= 2
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert mesh["val_loss"] == pytest.approx(one["val_loss"], rel=1e-3)


def test_evaluate_pala_on_the_mesh_matches_one_device(tmp_path):
    """tests/test_cli_e2e.py:330: PALA data, whose sharded rows are the
    channel-flattened frames (2 frames a batch, 1 a rank)."""
    root = generate_pala_dataset(tmp_path / "pala_synth", n_sequences=2,
                                 n_frames=6, n_channels=16, n_samples=400)
    over = dict(evaluate=True, th=None, sequences=[0, 1], ch_gap=4,
                batch_size=2)
    mesh = pmain.run(_cfg("port", tmp_path, root, **over, **MESH))
    one = pmain.run(_cfg("port", tmp_path, root, **over))
    assert mesh["random_init"] and np.isfinite(mesh["val_loss"])
    _assert_summary(mesh, one)


def test_array_members_ride_the_mesh(chirp, tmp_path):
    """``cli/array.py seeds=2 mesh=True mesh_dp=2``: a member a rank, the
    members' losses gathered in member order, those of the array on one
    rank; each rank writes its member's checkpoint."""
    root, _ = chirp
    losses = {}
    for name, over in (("mesh", MESH), ("one", {})):
        cfg = _cfg("port", tmp_path, root, seeds=2, epochs=1, **over)
        out = parray.run(cfg)
        losses[name] = [e["train_loss_members"]
                        for e in _events(cfg, out["run_name"], "train")]
        assert all(Path(m["checkpoint"]).is_file() for m in out["members"])
    np.testing.assert_allclose(losses["mesh"], losses["one"], rtol=1e-5,
                               atol=1e-6)


def test_array_threshold_sweep_runs_on_one_device(chirp):
    """``th_sweep=`` shards nothing under ``mesh=True`` (JAX's sweep runs
    on one device): the rows of the run without a mesh, no rank
    started."""
    root, dirs = chirp
    rows = {}
    for name, over in (("mesh", MESH), ("one", {})):
        cfg = _cfg("port", dirs["port"], root, evaluate=True,
                   model_file="shared-init", th_sweep=[0.01, 0.1], **over)
        rows[name] = parray.run(cfg)["rows"]
    assert rows["mesh"] == rows["one"] and not live()


def test_multihost_demo_workers_agree_with_one_process():
    """tests/test_parallel.py:330: two processes joined by
    ``init_distributed`` print the same finite losses, those of one
    process on the global batches."""
    out = multihost_demo.main()
    assert out["processes"] == 2 and all(np.isfinite(out["losses"]))
    assert out["max_deviation"] < 5e-3


# ---- the daemon ----------------------------------------------------------

@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A seeded StofNet's checkpoint, its batch-polymorphic artifact and
    those at the fixed batches 3 and 4 (by batch), and 6 echo rows."""
    d = tmp_path_factory.mktemp("mesh_daemon")
    state = StofNet(generator=torch.Generator().manual_seed(0),
                    device="cpu").state_dict()
    save_checkpoint(d / "armadillo-seed0.pt", state)
    ov = {"upsample_factor": 4}
    poly = save_pipeline(d / "b.pt2", export_pipeline(
        state, ov, "b", LENGTH, device="cpu", max_echoes=8))
    fixed = {b: save_pipeline(d / f"fixed{b}.pt2", export_pipeline(
        state, ov, b, LENGTH, device="cpu", max_echoes=8)) for b in (3, 4)}
    return d, poly, fixed, gate_batch(6, LENGTH, np.random.default_rng(5))


def _daemon(args, rows):
    hostd, server, port = build(args)
    try:
        with ServingClient(("127.0.0.1", port)) as c:
            got = [c.infer(r) for r in rows[:, 0]]
            got.append(c.infer(rows[:, 0]))
        return np.concatenate([np.stack(got[:-1]), got[-1]]), hostd.stats()
    finally:
        server.shutdown()
        server.server_close()
        hostd.close()


@pytest.mark.parametrize("source", ["checkpoint", "artifact"])
def test_mesh_daemon_rows_equal_the_daemons(served, source):
    """tests/test_serve.py:480: dp=2 replicas on the CPU answer every row
    as the daemon without a mesh; the buckets are the dp-divisible ones
    (JAX's ``_mesh_adjust``)."""
    d, poly, _, rows = served
    args = ({"model_file": "armadillo", "ckpt_dir": str(d),
             "length": LENGTH, "device": "cpu", "dtype": "float32",
             "max_echoes": 8} if source == "checkpoint"
            else {"artifact": str(poly)})
    args.update(max_batch=MAX_BATCH, max_wait_ms=2, port=0)
    want, _ = _daemon(args, rows)
    got, stats = _daemon(dict(args, **MESH), rows)
    np.testing.assert_array_equal(got, want)
    assert sorted(stats["bucket_counts"]) == [2, 4, 8]
    assert sum(stats["bucket_counts"].values()) >= 2


@pytest.mark.parametrize("over,match", [
    (dict(max_batch=6, mesh_dp=4), "max_batch=6 must be divisible by the "
     "dp mesh size 4"),
    (dict(artifact=3, max_batch=3), "max_batch=3 must be divisible "
     "by the dp mesh size 2"),
    (dict(artifact=4, max_batch=4), "exported at batch=4 runs that whole "
     "batch on each of the dp=2 replicas"),
    (dict(mesh_sp=2, input_enc="s16"), "A.6c"),
])
def test_mesh_daemon_refusals(served, over, match):
    """tests/test_serving_codecs.py:254: JAX's refusals; a fixed
    artifact's batch is its max_batch. A fixed artifact whose batch dp
    divides is refused too: each replica runs the program's whole batch
    (a departure; JAX's one program takes a slice a device)."""
    d, _, fixed, _ = served
    args = {"model_file": "armadillo", "ckpt_dir": str(d), "length": LENGTH,
            "device": "cpu", "dtype": "float32", "port": 0, **MESH}
    if over.get("artifact"):
        args = {"artifact": str(fixed[over["artifact"]]), "port": 0,
                **MESH}
        over = {k: v for k, v in over.items() if k != "artifact"}
    args.update(over)
    with pytest.raises(SystemExit, match=match):
        build(args)


def test_mesh_serve_check_rows_agree_across_mesh_sizes(capsys):
    """``scripts/mesh_serve_check.py`` on the CPU: the daemon at dp=1 and
    dp=2 answers a whole batch with the same rows."""
    assert mesh_serve_check.main(["--device", "cpu", "--dp", "1", "2",
                                  "--length", "800", "--batch", "4",
                                  "--requests", "1"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["dp"] for x in lines] == [1, 2]
    assert all(x["rows_equal_first"] for x in lines)
