"""The port's training and evaluation driver (``stofnet_tpu_torch/cli/main.py``)
against the JAX package's (``stofnet_tpu/cli/main.py``), on the CPU.

Both drivers read one stand-in chirp dataset (the fixture of
``tests/test_cli_e2e.py``: 3 positions, 4 train and 2 test measurements a
position, ``sample_num=400``; here at ``rf_scale_factor=4``, L=1600) and
start from one ``.pth``, written from a JAX ``StofNet().init`` through
``params_to_state_dict``, found as ``model_file=`` in each driver's
``ckpt_dir`` (one directory each, so their run names cannot collide). A
run trains one epoch, then ``resume=`` continues it to epoch 2 with
``export_pth=True``. Batches are equal bit for bit (numpy on both sides,
``tests/test_torch_data.py``), so what differs is the order of f32 sums.

Tolerances:
- train losses rtol 1e-4 (the f32 step's, ``tests/test_torch_train.py``);
- the epochs' ``val_loss`` rtol 1e-4, their ToA distance and Jaccard
  (decoded coords) equal up to 1e-6;
- ``evaluate=True`` from each driver's own final checkpoint:
  ``val_loss`` rtol 1e-4, ``total_distance_mean`` and ``total_jaccard``
  up to 1e-6, in f32 and with ``int8=True`` (the same s8 codes on both
  sides: the int8 test's agreement);
- the amp run's first loss rtol 2e-3 (bf16: JAX's step in bf16 and in f32
  differ by 1.1e-4 in the first loss at this size,
  ``tests/test_torch_train.py``);
- ``export_pth``: JAX's ``import_stofnet`` reads the port's final
  parameters exactly.
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
from stofnet_tpu.models.torch_import import import_stofnet
from stofnet_tpu.utils.config import load_config as jload_config
from stofnet_tpu_torch.cli import main as pmain
from stofnet_tpu_torch.models.stofnet import StofNet
from stofnet_tpu_torch.models.torch_import import (
    params_to_state_dict, save_torch_state_dict,
)
from stofnet_tpu_torch.utils.config import load_config

RF = 4
COMMON = dict(batch_size=4, rf_scale_factor=RF, max_echoes=8,
              plot_interval=0, model="stofnet")
RTOL = 1e-4
METRIC_ATOL = 1e-6


@pytest.fixture(scope="module")
def chirp_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli") / "stof_chirp101_dataset"
    return generate_chirp_dataset(root, n_positions=3, n_train_per_pos=4,
                                  n_test_per_pos=2, sample_num=400)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """One ckpt_dir per driver, each holding the shared ``.pth``."""
    base = tmp_path_factory.mktemp("drivers")
    variables = JaxStofNet().init(jax.random.key(7),
                                  np.zeros((1, 1, 400 * RF), np.float32))
    pth = base / "shared-init.pth"
    save_torch_state_dict(params_to_state_dict(variables), str(pth))
    out = {}
    for side in ("jax", "port"):
        (base / side / "ckpts").mkdir(parents=True)
        shutil.copy(pth, base / side / "ckpts" / pth.name)
        out[side] = base / side
    return out


def _cfg(side, dirs, chirp_root, **over):
    cfg = (jload_config(jmain.DEFAULT_CONFIG) if side == "jax"
           else load_config(pmain.DEFAULT_CONFIG))
    cfg.update(run_dir=str(dirs[side] / "runs"),
               ckpt_dir=str(dirs[side] / "ckpts"),
               data_dir=str(chirp_root), **COMMON)
    if side == "port":
        cfg.update(device="cpu")
    cfg.update(over)
    return cfg


def _run(side, cfg):
    return (jmain if side == "jax" else pmain).run(cfg)


def _events(cfg, run_name, kind):
    path = Path(cfg.run_dir) / f"{run_name}.jsonl"
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    return [r for r in rows if r.get("event") == kind]


@pytest.fixture(scope="module")
def trained(dirs, chirp_root):
    """Each driver: one epoch from the shared weights, then resumed from
    its checkpoint to epoch 2 with export_pth."""
    out = {}
    for side in ("jax", "port"):
        cfg1 = _cfg(side, dirs, chirp_root, epochs=1,
                    model_file="shared-init")
        out1 = _run(side, cfg1)
        cfg2 = _cfg(side, dirs, chirp_root, epochs=2,
                    model_file="shared-init", resume=out1["checkpoint"],
                    export_pth=True)
        out2 = _run(side, cfg2)
        out[side] = dict(
            first=out1, second=out2,
            train=[e["train_loss"]
                   for c, o in ((cfg1, out1), (cfg2, out2))
                   for e in _events(c, o["run_name"], "train")],
            epochs=[e for c, o in ((cfg1, out1), (cfg2, out2))
                    for e in _events(c, o["run_name"], "epoch")])
    return out


def test_train_losses_match_jax(trained):
    jx, pt = trained["jax"], trained["port"]
    assert len(pt["train"]) == len(jx["train"]) == 10  # 20 items, B=4, 2 ep
    np.testing.assert_allclose(pt["train"], jx["train"], rtol=RTOL)


def test_epochs_val_loss_and_metrics_match_jax(trained):
    jx, pt = trained["jax"], trained["port"]
    assert [e["epoch"] for e in pt["epochs"]] == [0, 1]
    for p, j in zip(pt["epochs"], jx["epochs"]):
        np.testing.assert_allclose(p["val_loss"], j["val_loss"], rtol=RTOL)
        np.testing.assert_allclose(p["train_loss"], j["train_loss"],
                                   rtol=RTOL)
        for k in ("val_toa_distance", "val_toa_jaccard"):
            np.testing.assert_allclose(p[k], j[k], atol=METRIC_ATOL)
        np.testing.assert_allclose(p["lr"], j["lr"], rtol=1e-6)


def test_resume_continues_to_epoch_2(trained):
    for side in ("jax", "port"):
        first, second = trained[side]["first"], trained[side]["second"]
        assert first["epochs"] == 1
        assert second["epochs"] == 2
        assert Path(second["checkpoint"]).name.endswith("epoch_2")


def test_export_pth_reads_in_jax_as_the_final_parameters(trained):
    out = trained["port"]["second"]
    variables, overrides = import_stofnet(out["export_pth"])
    assert overrides == {"upsample_factor": 4}
    final = torch.load(out["checkpoint"], map_location="cpu",
                       weights_only=True)
    assert final["epoch"] == 2
    got = params_to_state_dict(variables)
    assert set(got) == set(final["model"])
    for k, v in final["model"].items():
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)


@pytest.mark.parametrize("int8", [False, True])
def test_evaluate_from_own_checkpoint_matches_jax(trained, dirs, chirp_root,
                                                  int8):
    summaries = {}
    for side in ("jax", "port"):
        name = Path(trained[side]["second"]["checkpoint"]).name
        cfg = _cfg(side, dirs, chirp_root, evaluate=True, batch_size=2,
                   model_file=name, th=None, int8=int8)
        summaries[side] = _run(side, cfg)
    jx, pt = summaries["jax"], summaries["port"]
    assert pt.get("int8", False) == int8 and "random_init" not in pt
    np.testing.assert_allclose(pt["val_loss"], jx["val_loss"], rtol=RTOL)
    for k in ("total_distance_mean", "total_jaccard"):
        np.testing.assert_allclose(pt[k], jx[k], atol=METRIC_ATOL)
    assert np.isfinite(pt["total_inference_time"])


def test_amp_first_loss_matches_jax(dirs, chirp_root):
    first = {}
    for side in ("jax", "port"):
        cfg = _cfg(side, dirs, chirp_root, epochs=1, amp=True,
                   model_file="shared-init")
        out = _run(side, cfg)
        losses = [e["train_loss"]
                  for e in _events(cfg, out["run_name"], "train")]
        assert np.all(np.isfinite(losses))
        first[side] = losses[0]
    np.testing.assert_allclose(first["port"], first["jax"], rtol=2e-3)


def test_non_finite_loss_raises(dirs, chirp_root):
    cfg = _cfg("port", dirs, chirp_root, epochs=1, lr=1e30)
    with pytest.raises(RuntimeError, match="non-finite train loss"):
        pmain.run(cfg)


@pytest.mark.parametrize("over,error,match", [
    (dict(mesh=True, mesh_sp=2, int8=True), ValueError, "SERVING path"),
    (dict(mesh=True, mesh_dp=3), ValueError,
     "batch_size=4 not divisible by mesh_dp=3"),
])
def test_later_slices_are_refused(dirs, chirp_root, over, error, match):
    """int8 training is refused on a mesh as without one (int8 evaluates
    under sp since ROADMAP A.6c); a batch that dp does not divide is
    refused as JAX's ``_shard_inputs`` refuses it, before any rank
    starts."""
    cfg = _cfg("port", dirs, chirp_root, **over)
    with pytest.raises(error, match=match):
        pmain.run(cfg)


def test_cpu_needs_asking(dirs, chirp_root, monkeypatch):
    """Without a card and without device=cpu, setup raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfg("port", dirs, chirp_root)
    del cfg["device"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pmain.setup(cfg)


def test_setup_random_init_is_seeded(dirs, chirp_root):
    """No model_file: a fresh StofNet from torch.Generator().manual_seed(
    seed), marked random_init, the same weights for the same seed."""
    a = pmain.setup(_cfg("port", dirs, chirp_root))
    b = StofNet(generator=torch.Generator().manual_seed(3008), device="cpu")
    assert a["random_init"]
    for k, v in b.state_dict().items():
        assert torch.equal(a["model"].state_dict()[k], v), k
