"""The port's driver (``stofnet_tpu_torch/cli/main.py``) against the JAX
package's for the model zoo, on the CPU: edsr, espcn and zonzini train and
evaluate here, Kuleshov (whose dropout draws cannot match) and gradpeak
(no parameters) evaluate; the BatchNorm families unet and sincnet are in
``tests/test_torch_cli_main_zoo_bn.py``.

Both drivers read the stand-in chirp dataset of ``test_torch_cli_main.py``
(3 positions, 4 train and 2 test measurements a position,
``sample_num=400``, ``rf_scale_factor=4``: L=1600, 6400 for the unet after
its fold) and start from one ``.pth`` that JAX's
``registry.export_checkpoint`` writes from the family's ``init``, found as
``model_file=`` in each driver's own ``ckpt_dir``. Batches are equal bit
for bit, so what differs is the order of f32 sums. Tolerances: train
losses, the epoch's ``val_loss`` and ``train_loss`` rtol 1e-4; the decoded
metrics (distance, Jaccard) up to 1e-6; ``evaluate=True``: ``val_loss``
rtol 1e-4, ``total_distance_mean`` and ``total_jaccard`` up to 1e-6.
"""

import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stofnet_tpu.cli import main as jmain
from stofnet_tpu.data.synthetic import generate_chirp_dataset
from stofnet_tpu.models import build_model as jbuild
from stofnet_tpu.models.registry import export_checkpoint as jexport
from stofnet_tpu.utils.config import load_config as jload_config
from stofnet_tpu_torch.cli import main as pmain
from stofnet_tpu_torch.models import build_model
from stofnet_tpu_torch.utils.config import load_config

RF, SAMPLES, FS = 4, 400, 1_000_000.0
COMMON = dict(batch_size=4, rf_scale_factor=RF, max_echoes=8,
              plot_interval=0)
RTOL = 1e-4
METRIC_ATOL = 1e-6
METRICS = ("total_distance_mean", "total_jaccard")


def make_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli") / "stof_chirp101_dataset"
    return generate_chirp_dataset(root, n_positions=3, n_train_per_pos=4,
                                  n_test_per_pos=2, sample_num=SAMPLES)


def make_dirs(base: Path, name: str = None):
    """One ckpt_dir per driver, each holding family ``name``'s shared
    ``.pth`` (JAX's ``export_checkpoint`` of its ``init``, seed 7)."""
    base.mkdir(parents=True, exist_ok=True)
    out = {}
    pth = base / f"{name}-init.pth"
    if name not in (None, "gradpeak"):
        model, up = jbuild(name, sample_num=SAMPLES, rf_scale_factor=RF,
                           fs=FS)
        length = SAMPLES * up.get("rf_scale_factor", RF)
        variables = jax.jit(model.init)(jax.random.key(7),
                                        jnp.zeros((1, 1, length)))
        jexport(name, variables, str(pth))
    for side in ("jax", "port"):
        (base / side / "ckpts").mkdir(parents=True)
        if pth.exists():
            shutil.copy(pth, base / side / "ckpts" / pth.name)
        out[side] = base / side
    return out


def cfg_of(side, dirs, root, name, **over):
    cfg = (jload_config(jmain.DEFAULT_CONFIG) if side == "jax"
           else load_config(pmain.DEFAULT_CONFIG))
    cfg.update(run_dir=str(dirs[side] / "runs"),
               ckpt_dir=str(dirs[side] / "ckpts"), data_dir=str(root),
               model=name, model_file=f"{name}-init", **COMMON)
    if side == "port":
        cfg.update(device="cpu")
    cfg.update(over)
    return cfg


def run(side, cfg):
    return (jmain if side == "jax" else pmain).run(cfg)


def events(cfg, run_name, kind):
    path = Path(cfg.run_dir) / f"{run_name}.jsonl"
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    return [r for r in rows if r.get("event") == kind]


def train_pair(dirs, root, name):
    """One epoch of each driver from the shared ``.pth``, with
    ``export_pth``: {side: (summary, train losses, epoch events)}."""
    out = {}
    for side in ("jax", "port"):
        cfg = cfg_of(side, dirs, root, name, epochs=1, export_pth=True)
        summary = run(side, cfg)
        out[side] = (summary,
                     [e["train_loss"]
                      for e in events(cfg, summary["run_name"], "train")],
                     events(cfg, summary["run_name"], "epoch"))
    return out


def assert_train_pair(out, val_rtol=RTOL):
    (_, jl, je), (ps, pl, pe) = out["jax"], out["port"]
    assert len(pl) == len(jl) == 5  # 20 train items, B=4
    np.testing.assert_allclose(pl, jl, rtol=RTOL)
    assert [e["epoch"] for e in pe] == [0]
    for p, j in zip(pe, je):
        np.testing.assert_allclose(p["train_loss"], j["train_loss"],
                                   rtol=RTOL)
        np.testing.assert_allclose(p["val_loss"], j["val_loss"],
                                   rtol=val_rtol)
        for k in ("val_toa_distance", "val_toa_jaccard"):
            np.testing.assert_allclose(p[k], j[k], atol=METRIC_ATOL)
    assert Path(ps["export_pth"]).is_file()


def eval_pair(dirs, root, name, **over):
    """``evaluate=True`` of each driver from the shared ``.pth``."""
    out = {side: run(side, cfg_of(side, dirs, root, name, evaluate=True,
                                  batch_size=2, **over))
           for side in ("jax", "port")}
    jx, pt = out["jax"], out["port"]
    assert "random_init" not in pt and "random_init" not in jx
    np.testing.assert_allclose(pt["val_loss"], jx["val_loss"], rtol=RTOL)
    for k in METRICS:
        np.testing.assert_allclose(pt[k], jx[k], atol=METRIC_ATOL)
    assert np.isfinite(pt["total_inference_time"])
    return out


@pytest.fixture(scope="module")
def chirp_root(tmp_path_factory):
    return make_root(tmp_path_factory)


@pytest.fixture(scope="module")
def family_dirs(tmp_path_factory):
    base = tmp_path_factory.mktemp("zoo")
    return lambda tag, name=None: make_dirs(base / tag, name)


@pytest.mark.parametrize("name", ["edsr", "espcn", "zonzini"])
def test_train_and_evaluate_match_jax(family_dirs, chirp_root, name):
    dirs = family_dirs(name, name)
    out = train_pair(dirs, chirp_root, name)
    assert_train_pair(out)
    # the exported .pth holds the run's final parameters
    final = torch.load(out["port"][0]["checkpoint"], weights_only=True)
    pth = torch.load(out["port"][0]["export_pth"], weights_only=True)
    assert pth.keys() == final["model"].keys()
    for k, v in final["model"].items():
        assert torch.equal(pth[k], v), k
    eval_pair(dirs, chirp_root, name)


@pytest.mark.parametrize("name,over", [
    ("kuleshov", {}), ("gradpeak", dict(th=1e-3))])
def test_evaluate_matches_jax(family_dirs, chirp_root, name, over):
    out = eval_pair(family_dirs(name, name), chirp_root, name, **over)
    if name == "gradpeak":  # the detector finds the echoes
        assert np.isfinite(out["port"]["total_distance_mean"])


def test_gradpeak_forces_evaluate_and_zonzini_is_a_regression(
        family_dirs, chirp_root):
    dirs = family_dirs("setup")
    ctx = pmain.setup(cfg_of("port", dirs, chirp_root, "gradpeak"))
    assert ctx["cfg"].evaluate and not ctx["random_init"]
    assert ctx["model_kind"] == "regression"
    assert ctx["dataset"].split_dirname == "test"
    ctx = pmain.setup(cfg_of("port", dirs, chirp_root, "zonzini"))
    assert ctx["model_kind"] == "regression" and ctx["random_init"]
    with pytest.raises(ValueError, match="stofnet only"):
        pmain.run(cfg_of("port", dirs, chirp_root, "edsr", evaluate=True,
                         int8=True))


def test_setup_random_init_is_seeded(family_dirs, chirp_root):
    """No checkpoint: a fresh model from torch.Generator().manual_seed(
    seed) through the registry, marked random_init."""
    ctx = pmain.setup(cfg_of("port", family_dirs("seeded"), chirp_root,
                             "kuleshov", model_file=None))
    ref, _ = build_model("kuleshov", sample_num=SAMPLES, rf_scale_factor=RF,
                         fs=FS, device="cpu",
                         generator=torch.Generator().manual_seed(3008))
    assert ctx["random_init"]
    for k, v in ref.state_dict().items():
        assert torch.equal(ctx["model"].state_dict()[k], v), k
