"""The port's job-array driver (``stofnet_tpu_torch/cli/array.py``) on the
CPU: training members against solo steps, their checkpoints through
``cli/main.py``, evaluation against JAX's driver, and the refusals.

One stand-in chirp dataset (``generate_chirp_dataset``: 3 positions, 4
train and 2 test measurements a position, ``sample_num=200``, here at
``rf_scale_factor=4``: L=800) feeds both drivers. The array evaluation
reads two member checkpoints of a port array exported as reference
``.pth`` files, one copy in each driver's ``ckpt_dir``. Tolerances:
- a member's first logged loss against a solo ``make_train_step`` from
  the member's init on the driver's first batch: rtol 1e-5;
- ``model_files=`` and ``th_sweep=`` rows against JAX's driver on the
  same ``.pth`` files: the metrics rtol = atol = 1e-5, ``val_loss`` rtol
  1e-4 (``tests/test_array.py:121-123``).
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from stofnet_tpu.cli import array as jarray_cli
from stofnet_tpu.cli import main as jmain
from stofnet_tpu.utils.config import load_config as jload_config
from stofnet_tpu_torch.cli import array as array_cli
from stofnet_tpu_torch.cli import main as pmain
from stofnet_tpu_torch.data.loader import DataLoader, split_dataset
from stofnet_tpu_torch.data.synthetic import generate_chirp_dataset
from stofnet_tpu_torch.models.registry import export_checkpoint
from stofnet_tpu_torch.train import (
    load_checkpoint, make_optimizer, make_train_step,
)
from stofnet_tpu_torch.utils.config import load_config

COMMON = dict(model="stofnet", rf_scale_factor=4, max_echoes=8,
              plot_interval=0)


@pytest.fixture(scope="module")
def chirp_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("array_cli") / "stof_chirp101_dataset"
    return generate_chirp_dataset(root, n_positions=3, n_train_per_pos=4,
                                  n_test_per_pos=2, sample_num=200)


def _cfg(base, chirp_root, jax=False, **over):
    cfg = (jload_config(jmain.DEFAULT_CONFIG) if jax
           else load_config(pmain.DEFAULT_CONFIG))
    cfg.update(run_dir=str(base / "runs"), ckpt_dir=str(base / "ckpts"),
               data_dir=str(chirp_root), **COMMON)
    if not jax:
        cfg.update(device="cpu")
    cfg.update(over)
    return cfg


def _events(cfg, run_name, kind):
    path = Path(cfg.run_dir) / f"{run_name}.jsonl"
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    return [r for r in rows if r.get("event") == kind]


@pytest.fixture(scope="module")
def trained(tmp_path_factory, chirp_root):
    base = tmp_path_factory.mktemp("train")
    cfg = _cfg(base, chirp_root, seeds=2, epochs=1, batch_size=4,
               crop_ratio=0.75)
    return cfg, array_cli.run(cfg.copy())


def test_train_array_members_start_as_solo_steps(trained):
    """Member i's first loss is a solo step's from seed i's init on the
    driver's first batch; its checkpoint is a single model's, with its own
    AdamW moments and step."""
    cfg, out = trained
    assert out["mode"] == "train_array" and out["epochs"] == 1
    seeds = [m["seed"] for m in out["members"]]
    assert seeds == [3008, 3009] and out["best_seed"] in seeds
    first = _events(cfg, out["run_name"], "train")[0]["train_loss_members"]
    assert first[0] != first[1]
    steps = len(_events(cfg, out["run_name"], "train"))
    for i, (seed, m) in enumerate(zip(seeds, out["members"])):
        ctx = pmain.setup(cfg.copy())  # the data of the run's seed
        model = ctx["build"](torch.Generator().manual_seed(seed))
        train_idx, _ = split_dataset(len(ctx["dataset"]), 0.2,
                                     seed=int(cfg.seed))
        loader = DataLoader(ctx["dataset"], train_idx, batch_size=4,
                            shuffle=True, drop_last=True, seed=int(cfg.seed))
        loader.set_epoch(0)
        frame, gt = pmain.batch_to_arrays(next(iter(loader)))
        gt_true = np.round(gt[:, None, :] * 4).astype(np.int32)
        opt, sched = make_optimizer(model.parameters())
        step = make_train_step(model, opt, sched, pmain._loss_config(cfg))
        loss = step(*map(torch.from_numpy, (frame, gt, gt_true)))["loss"]
        np.testing.assert_allclose(first[i], float(loss), rtol=1e-5)

        ckpt = load_checkpoint(m["checkpoint"])
        assert ckpt["model"].keys() == model.state_dict().keys()
        assert ckpt["step"] == steps and ckpt["epoch"] == 1
        params = dict(model.named_parameters())
        for j, (k, p) in enumerate(params.items()):
            moments = ckpt["optimizer"]["state"][j]
            assert moments["exp_avg"].shape == p.shape, k
        assert np.isfinite(m["val_loss"])


def test_member_checkpoint_resumes_and_evaluates_in_cli_main(trained,
                                                            tmp_path):
    cfg, out = trained
    ckpt = Path(out["members"][1]["checkpoint"])
    res = pmain.run(_cfg(tmp_path, cfg.data_dir, epochs=2, batch_size=4,
                         crop_ratio=0.75, seed=3009, resume=str(ckpt)))
    assert res["epochs"] == 2 and np.isfinite(res["val_loss"])
    ev = pmain.run(_cfg(tmp_path, cfg.data_dir, evaluate=True, batch_size=2,
                        ckpt_dir=str(ckpt.parent), model_file=ckpt.name))
    assert not ev.get("random_init") and np.isfinite(ev["val_loss"])


@pytest.fixture(scope="module")
def pth_dirs(trained, tmp_path_factory):
    """The two members as reference .pth files, a copy for each driver."""
    _, out = trained
    base = tmp_path_factory.mktemp("pth")
    names = []
    for i, m in enumerate(out["members"]):
        names.append(f"member{i}-seed{m['seed']}")
        export_checkpoint("stofnet", load_checkpoint(m["checkpoint"])[
            "model"], base / f"{names[-1]}.pth")
    dirs = {}
    for side in ("jax", "port"):
        (base / side / "ckpts").mkdir(parents=True)
        for n in names:
            shutil.copy(base / f"{n}.pth", base / side / "ckpts")
        dirs[side] = base / side
    return dirs, names


def _rows(dirs, names, chirp_root, **over):
    out = {}
    for side, run in (("jax", jarray_cli.run), ("port", array_cli.run)):
        cfg = _cfg(dirs[side], chirp_root, jax=side == "jax", evaluate=True,
                   batch_size=2, etol=1600, **over)
        out[side] = run(cfg)
    return out


def _assert_rows_match(out):
    assert out["port"]["mode"] == out["jax"]["mode"]
    for got, ref in zip(out["port"]["rows"], out["jax"]["rows"],
                        strict=True):
        assert got["member"] == ref["member"]
        for k in ("total_distance_mean", "total_distance_std",
                  "total_jaccard", "precision", "recall"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5,
                                       atol=1e-5, err_msg=k)
        if "val_loss" in ref:
            np.testing.assert_allclose(got["val_loss"], ref["val_loss"],
                                       rtol=1e-4)


def test_model_files_rows_match_jax(pth_dirs, chirp_root):
    dirs, names = pth_dirs
    out = _rows(dirs, names, chirp_root, model_files=names, th=0.001)
    _assert_rows_match(out)
    assert [r["member"] for r in out["port"]["rows"]] == names
    table = Path(dirs["port"] / "runs" /
                 f"{out['port']['run_name']}_array_table.md").read_text()
    assert all(n in table for n in names)


def test_th_sweep_rows_match_jax(pth_dirs, chirp_root):
    dirs, names = pth_dirs
    out = _rows(dirs, names, chirp_root, model_file=names[0],
                th_sweep=[0.001, 0.01, 0.1])
    _assert_rows_match(out)
    assert [r["member"] for r in out["port"]["rows"]] == [
        "th=0.001", "th=0.01", "th=0.1"]


def test_lr_sweep_members_share_an_init(chirp_root, tmp_path):
    cfg = _cfg(tmp_path, chirp_root, lrs=[1e-4, 5e-4], epochs=1,
               batch_size=4, crop_ratio=0.75)
    out = array_cli.run(cfg.copy())
    assert [m["lr"] for m in out["members"]] == [1e-4, 5e-4]
    assert {m["seed"] for m in out["members"]} == {3008}
    paths = [m["checkpoint"] for m in out["members"]]
    assert "lr0.0001" in paths[0] and "lr0.0005" in paths[1]
    assert out["best_lr"] in (1e-4, 5e-4)
    losses = [e["train_loss_members"]
              for e in _events(cfg, out["run_name"], "train")]
    assert losses[0][0] == losses[0][1] and losses[1][0] != losses[1][1]
    opt = load_checkpoint(paths[1])["optimizer"]
    assert opt["param_groups"][0]["initial_lr"] == pytest.approx(5e-4)


@pytest.mark.parametrize("over,error,match", [
    (dict(lrs=[1e-4, 1e-4]), ValueError, "duplicate lrs"),
    (dict(lrs=[1e-4, 5e-4], seeds=3), ValueError, "seeds=3 but 2 lrs"),
    (dict(lrs=[1e-4, -1.0]), ValueError, "lrs must be positive"),
    (dict(evaluate=True, th_sweep=[0.0, 0.1]), ValueError, "must be > 0"),
    (dict(evaluate=True, model_files=["no-such-ckpt"]), FileNotFoundError,
     "no-such-ckpt"),
    (dict(evaluate=True), ValueError, "model_files"),
    (dict(seeds=2, mesh=True, mesh_sp=2), ValueError, "mesh_sp must be 1"),
    (dict(evaluate=True, model_files=["x", "y", "z"], mesh=True,
          mesh_dp=2), ValueError, "3 members not divisible by mesh dp=2"),
], ids=["duplicate_lrs", "seeds_lrs_mismatch", "negative_lr",
        "falsy_th_sweep", "missing_prefix", "no_mode", "mesh_train",
        "mesh_eval"])
def test_refusals(chirp_root, tmp_path, over, error, match):
    cfg = _cfg(tmp_path, chirp_root, epochs=1, batch_size=4, **over)
    with pytest.raises(error, match=match):
        array_cli.run(cfg)


def test_non_finite_member_loss_names_the_member(chirp_root, tmp_path,
                                                  monkeypatch):
    make = array_cli.make_array_train_step

    def poisoned(*a, **kw):
        step = make(*a, **kw)

        def run(*b):
            out = step(*b)
            out["loss"][1] = float("nan")
            return out
        return run

    monkeypatch.setattr(array_cli, "make_array_train_step", poisoned)
    cfg = _cfg(tmp_path, chirp_root, seeds=2, epochs=1, batch_size=4)
    with pytest.raises(RuntimeError, match=r"\['seed3009'\]"):
        array_cli.run(cfg)


def test_eval_array_profile_dir_writes_a_trace(pth_dirs, chirp_root,
                                               tmp_path):
    dirs, names = pth_dirs
    cfg = _cfg(dirs["port"], chirp_root, evaluate=True, batch_size=2,
               model_file=names[0], th_sweep=[0.01, 0.1],
               profile_dir=str(tmp_path / "trace"), profile_steps=1)
    array_cli.run(cfg)
    assert list((tmp_path / "trace").glob("trace_*.json"))
