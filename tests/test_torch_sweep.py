"""The port's sweep and report (``stofnet_tpu_torch/cli/sweep.py``,
``cli/report.py``) against the JAX package's, on the CPU.

The tables, notes and the formatter are copies: ``SWEEPS``,
``SWEEP_OVERRIDES``, ``CITATIONS``, the notes and ``format_table``'s
markdown and LaTeX are held equal, string for string, to JAX's on the
same results. A mini sweep of two rows (StofNet from one ``.pth`` written
from a JAX init, and gradpeak) runs through both drivers on one stand-in
chirp dataset: metrics rtol 1e-4; a third row whose prefix is missing runs
from random weights on both sides and carries the dagger.
"""

import json
import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from stofnet_tpu.cli import main as jmain
from stofnet_tpu.cli import sweep as jsweep
from stofnet_tpu.models import StofNet as JaxStofNet
from stofnet_tpu.utils.config import load_config as jload_config
from stofnet_tpu_torch.cli import main as pmain
from stofnet_tpu_torch.cli import report, sweep
from stofnet_tpu_torch.data.synthetic import generate_chirp_dataset
from stofnet_tpu_torch.models.torch_import import (
    params_to_state_dict, save_torch_state_dict,
)
from stofnet_tpu_torch.utils.config import load_config

RESULTS = [
    {"model": "stofnet", "ckpt": "different-armadillo",
     "total_distance_mean": 1.234, "total_distance_std": 0.5,
     "total_jaccard": 91.25, "total_parameters": 645764,
     "total_inference_time": 0.00123},
    {"model": "stofnet", "ckpt": "different-armadillo", "int8": True,
     "total_distance_mean": 1.3, "total_distance_std": 0.55,
     "total_jaccard": 90.0, "total_parameters": 645764,
     "total_inference_time": 0.0004},
    {"model": "zonzini", "ckpt": "graceful-wave", "random_init": True,
     "total_distance_mean": 50.0, "total_distance_std": 5.0,
     "total_jaccard": 0.0, "total_parameters": 134465,
     "total_inference_time": 0.001},
    {"model": "gradpeak", "ckpt": None, "total_distance_mean": 2.0,
     "total_distance_std": 1.0, "total_jaccard": 40.0,
     "total_inference_time": 0.002},
    {"model": "edsr", "ckpt": "proud-cherry", "error": "boom"},
    {"model": "unet", "ckpt": None, "total_distance_mean": float("nan"),
     "total_distance_std": float("nan"), "total_jaccard": float("nan"),
     "total_parameters": 0, "total_inference_time": float("nan")},
]


def test_sweep_tables_are_jax_copies():
    assert sweep.SWEEPS == jsweep.SWEEPS
    assert sweep.SWEEP_OVERRIDES == jsweep.SWEEP_OVERRIDES
    assert sweep.CITATIONS == jsweep.CITATIONS
    assert sweep.TIMING_NOTE == jsweep.TIMING_NOTE
    assert sweep.RANDOM_INIT_NOTE == jsweep.RANDOM_INIT_NOTE


@pytest.mark.parametrize("latex", [False, True], ids=["md", "latex"])
@pytest.mark.parametrize("rows", [slice(None), slice(0, 2)],
                         ids=["all", "no_dagger"])
def test_format_table_matches_jax(latex, rows):
    results = RESULTS[rows]
    got = sweep.format_table(results, latex=latex)
    assert got == jsweep.format_table(results, latex=latex)
    assert ("†" in got or "dagger" in got) == (rows == slice(None))


def test_write_tables_matches_jax(tmp_path):
    summary = {"total_parameters": 645764, "model_name": "stofnet"}
    out = {}
    for side, mod in (("jax", jsweep), ("port", sweep)):
        d = tmp_path / side
        d.mkdir()
        (d / "run-a_summary.json").write_text(json.dumps(summary))
        rows = [dict(RESULTS[0], run_name="run-a")]
        del rows[0]["total_parameters"]
        out[side] = (mod.write_tables(rows, d),
                     (d / "metrics_table.tex").read_text())
    assert out["port"] == out["jax"]
    assert "645.8" in out["port"][0]


@pytest.fixture(scope="module")
def chirp_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("sweep") / "stof_chirp101_dataset"
    return generate_chirp_dataset(root, n_positions=2, n_train_per_pos=2,
                                  n_test_per_pos=2, sample_num=200)


ROWS = [["stofnet", "shared-init", None], ["gradpeak", None, None],
        ["edsr", "no-such-ckpt", None]]


@pytest.fixture(scope="module")
def swept(tmp_path_factory, chirp_root):
    """Each driver's sweep of ROWS at the chirp protocol's batch 1 and etol
    1, rf_scale_factor 4 (L=800), from one shared ``.pth``."""
    base = tmp_path_factory.mktemp("drivers")
    variables = JaxStofNet().init(jax.random.key(7),
                                  np.zeros((1, 1, 800), np.float32))
    pth = base / "shared-init.pth"
    save_torch_state_dict(params_to_state_dict(variables), str(pth))
    out = {}
    for side in ("jax", "port"):
        (base / side / "ckpts").mkdir(parents=True)
        shutil.copy(pth, base / side / "ckpts" / pth.name)
        cfg = (jload_config(jmain.DEFAULT_CONFIG) if side == "jax"
               else load_config(pmain.DEFAULT_CONFIG))
        cfg.update(data_dir=str(chirp_root), run_dir=str(base / side / "runs"),
                   ckpt_dir=str(base / side / "ckpts"), max_echoes=8,
                   **sweep.SWEEP_OVERRIDES["chirp"])
        cfg.update(rf_scale_factor=4)
        if side == "port":
            cfg.update(device="cpu")
        out[side] = ((jsweep if side == "jax" else sweep).run_sweep(cfg, ROWS),
                     cfg.run_dir)
    return out


def test_mini_sweep_matches_jax(swept):
    got, ref = swept["port"][0], swept["jax"][0]
    assert [r["model"] for r in got] == [r[0] for r in ROWS]
    assert not any("error" in r for r in got)
    for g, r in zip(got[:2], ref[:2]):
        for k in ("total_distance_mean", "total_distance_std",
                  "total_jaccard", "val_loss"):
            np.testing.assert_allclose(g[k], r[k], rtol=1e-4, err_msg=k)
    assert got[2].get("random_init") and ref[2].get("random_init")
    assert not got[0].get("random_init") and not got[1].get("random_init")


def test_report_rebuilds_the_sweep_table(swept):
    """The report reads the rows' summaries (newest first) back into the
    sweep table's cells; a row's checkpoint is not in its summary, so its
    label names the model."""
    results, run_dir = swept["port"]
    md = sweep.write_tables(results, run_dir)
    assert "edsr (no-such-ckpt) †" in md and "RANDOM-INIT" in md
    report.main([f"run_dir={run_dir}", f"num_recent={len(ROWS)}"])
    rebuilt = (Path(run_dir) / "metrics_table.md").read_text()

    def cells(table):
        return [line.split("|")[1:-1] for line in table.splitlines()
                if line.startswith("| ") and "Method" not in line]

    for row, back in zip(cells(md), cells(rebuilt)[::-1], strict=True):
        assert row[1:] == back[1:]
        assert back[0].split()[0] == row[0].split()[0]
        assert ("†" in back[0]) == ("†" in row[0])
    assert (Path(run_dir) / "metrics_table.tex").exists()
    assert len(report.local_results(Path(run_dir), 1)) == 1


def test_sweep_main_protocol_overrides_yield_to_explicit_keys(chirp_root,
                                                              tmp_path):
    run_dir = tmp_path / "runs"
    sweep.main(["sweep=chirp", f"data_dir={chirp_root}", f"run_dir={run_dir}",
                "rows=[[gradpeak,null,null]]", "batch_size=2", "device=cpu",
                "max_echoes=8"])
    (log,) = run_dir.glob("*.jsonl")
    config = json.loads(log.read_text().splitlines()[0])
    assert config["batch_size"] == 2  # explicit beats the protocol's 1
    assert config["rf_scale_factor"] == 10 and config["etol"] == 1
    assert (run_dir / "metrics_table.md").exists()


def test_report_empty_dir_exits_1(tmp_path):
    with pytest.raises(SystemExit) as e:
        report.main([f"run_dir={tmp_path / 'nothing'}"])
    assert e.value.code == 1
    with pytest.raises(SystemExit) as e:
        report.main(["run_dir"])
    assert e.value.code == 2


def test_report_without_wandb_uses_local_summaries(tmp_path, monkeypatch,
                                                  capsys):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import fails
    assert report.wandb_results("chirp_array", 7) is None
    rd = tmp_path / "runs"
    rd.mkdir()
    for i, m in enumerate(["stofnet", "edsr"]):
        summary = {k: v for k, v in RESULTS[0].items()
                   if k not in ("model", "ckpt")}
        (rd / f"run{i}_summary.json").write_text(json.dumps(
            dict(summary, model_name=m, total_parameters=1000 + i)))
    report.main([f"run_dir={rd}", "wandb_group=chirp_array"])
    md = (rd / "metrics_table.md").read_text()
    assert "stofnet" in md and "edsr" in md
    assert "local summaries" in capsys.readouterr().err
