"""The port's driver (``stofnet_tpu_torch/cli/main.py``) against the JAX
package's on PALA and rat data, on the CPU: the PALA branch of
``build_dataset`` (``data/pala.PalaDatasetRf``, the temporal filter on a
path naming rat data, AddNoise only when training), ``batch_to_arrays``'
channel flattening, and training StofNet, ZonziniNetLarge and the unet at
its PALA depth (n_layers 10).

Both drivers read datasets written by ``data/pala.generate_pala_dataset``
(16 channels, 2 sequences of 6 frames; ``ch_gap=4``: 4 channels a frame,
8 waveforms a batch of 2 frames) and start from one ``.pth`` that JAX's
``registry.export_checkpoint`` writes from the family's ``init``. Lengths:
400 samples at rf 4 (L=1600) for StofNet, at rf 16 (6400) for zonzini;
256 samples at rf 1 for the unet (1024 after its x4 fold, 2^10).
Batches are equal bit for bit, so what differs is the order of f32 sums.
Tolerances: train losses, the epoch's ``train_loss`` and ``val_loss``
rtol 1e-4 (the chirp driver pairs'; the unet's ``val_loss`` 5e-3, the
BatchNorm pairs' ``VAL_RTOL``); decoded metrics up to 1e-6;
``evaluate=True``: ``val_loss`` rtol 1e-4.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stofnet_tpu.cli import main as jmain
from stofnet_tpu.models import build_model as jbuild
from stofnet_tpu.models.registry import export_checkpoint as jexport
from stofnet_tpu_torch.cli import main as pmain
from stofnet_tpu_torch.data.loader import DataLoader
from stofnet_tpu_torch.data.pala import generate_pala_dataset

from tests.test_torch_cli_main_zoo import (
    METRIC_ATOL, RTOL, cfg_of, events, run,
)
from tests.test_torch_cli_main_zoo_bn import VAL_RTOL

PALA = dict(sequences=[0, 1], ch_gap=4, batch_size=2, max_echoes=8,
            plot_interval=0)
FRAMES, CHANNELS = 6, 16


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """{kind: dataset root}: PALA at 400 and 256 samples, and a rat-named
    copy of the first."""
    base = tmp_path_factory.mktemp("drv")
    out = {"pala": generate_pala_dataset(
        base / "pala_synth", n_sequences=2, n_frames=FRAMES,
        n_channels=CHANNELS, n_samples=400),
        "pala_small": generate_pala_dataset(
            base / "pala_small", n_sequences=2, n_frames=FRAMES,
            n_channels=CHANNELS, n_samples=256)}
    out["rat"] = base / "rat_synth"
    shutil.copytree(out["pala"], out["rat"])
    return out


def make_dirs(base, name, rf, samples):
    """One ckpt_dir per driver, each holding the family's shared ``.pth``
    at its PALA widths (JAX's ``export_checkpoint``, n_layers 10)."""
    model, up = jbuild(name, dataset_kind="pala", sample_num=samples,
                       rf_scale_factor=rf)
    length = samples * up.get("rf_scale_factor", rf)
    variables = jax.jit(model.init)(jax.random.key(7),
                                    jnp.zeros((1, 1, length)))
    pth = base / f"{name}-init.pth"
    jexport(name, variables, str(pth), n_layers=10)
    out = {}
    for side in ("jax", "port"):
        (base / side / "ckpts").mkdir(parents=True)
        shutil.copy(pth, base / side / "ckpts" / pth.name)
        out[side] = base / side
    return out


def _cfg(side, dirs, root, name, rf, **over):
    cfg = cfg_of(side, dirs, root, name, rf_scale_factor=rf, **PALA)
    cfg.update(over)
    return cfg


def train_pair(tmp_path, root, name, rf, samples):
    dirs = make_dirs(tmp_path, name, rf, samples)
    out = {}
    for side in ("jax", "port"):
        cfg = _cfg(side, dirs, root, name, rf, epochs=1)
        summary = run(side, cfg)
        out[side] = (summary,
                     [e["train_loss"]
                      for e in events(cfg, summary["run_name"], "train")],
                     events(cfg, summary["run_name"], "epoch"))
    (_, jl, je), (_, pl, pe) = out["jax"], out["port"]
    # 12 frames (10 on rat data): 80/20 split, B=2
    assert len(pl) == len(jl) >= 4
    np.testing.assert_allclose(pl, jl, rtol=RTOL)
    for p, j in zip(pe, je):
        np.testing.assert_allclose(p["train_loss"], j["train_loss"],
                                   rtol=RTOL)
        # the unet's BatchNorm: the zero-gradient bias noise of
        # test_torch_cli_main_zoo_bn.VAL_RTOL in the running statistics
        np.testing.assert_allclose(p["val_loss"], j["val_loss"],
                                   rtol=VAL_RTOL if name == "unet" else RTOL)
        for k in ("val_toa_distance", "val_toa_jaccard"):
            np.testing.assert_allclose(p[k], j[k], atol=METRIC_ATOL)
    return dirs, out


@pytest.mark.parametrize("kind", ["pala", "rat"])
def test_stofnet_trains_and_evaluates_as_jax(kind, roots, tmp_path):
    """StofNet at L=1600: one epoch, then ``evaluate=True`` from each
    driver's own checkpoint; rat data through the temporal filter."""
    dirs, out = train_pair(tmp_path, roots[kind], "stofnet", 4, 400)
    summaries = {}
    for side in ("jax", "port"):
        ckpt = out[side][0]["checkpoint"]
        cfg = _cfg(side, dirs, roots[kind], "stofnet", 4, evaluate=True,
                   model_file=ckpt.rsplit("/", 1)[-1])
        summaries[side] = run(side, cfg)
    jx, pt = summaries["jax"], summaries["port"]
    assert "random_init" not in pt
    np.testing.assert_allclose(pt["val_loss"], jx["val_loss"], rtol=RTOL)
    for k in ("total_distance_mean", "total_jaccard"):
        np.testing.assert_allclose(pt[k], jx[k], atol=METRIC_ATOL,
                                   equal_nan=True)
    assert np.isfinite(pt["total_inference_time"])


@pytest.mark.parametrize("name,root,rf,samples", [
    ("zonzini", "pala", 16, 400),  # ZonziniNetLarge at L=6400
    ("unet", "pala_small", 1, 256),  # n_layers 10 at 1024 after the fold
])
def test_pala_width_families_train_as_jax(name, root, rf, samples, roots,
                                          tmp_path):
    train_pair(tmp_path, roots[root], name, rf, samples)


@pytest.mark.parametrize("kind", ["pala", "rat"])
@pytest.mark.parametrize("evaluate", [False, True])
def test_dataset_and_batches_are_jax_bit_for_bit(kind, evaluate, roots,
                                                 tmp_path):
    """``build_dataset``'s info (``wavelength`` included) and the first
    batch through ``batch_to_arrays``: wave index 1, channels flattened
    into the batch, GT <= 0 or NaN as 0; AddNoise only when training."""
    dirs = {"jax": tmp_path / "j", "port": tmp_path / "p"}
    got = {}
    for side, mod in (("jax", jmain), ("port", pmain)):
        cfg = _cfg(side, dirs, roots[kind], "stofnet", 4, evaluate=evaluate)
        ds, info = mod.build_dataset(cfg)
        batch = next(iter(DataLoader(ds, batch_size=2, drop_last=True)))
        got[side] = (info, mod.batch_to_arrays(batch, info["kind"]),
                     len(ds))
    (ji, (jf, jg), jn), (pi, (pf, pg), pn) = got["jax"], got["port"]
    assert pi == ji and pi["kind"] == kind and "wavelength" in pi
    assert pn == jn == 2 * (FRAMES - (kind == "rat"))
    assert pf.shape == (2 * CHANNELS // 4, 1, 1600) and pg.shape[1] == 32
    np.testing.assert_array_equal(pf, jf)
    np.testing.assert_array_equal(pg, jg)
    assert (pg >= 0).all() and (pg > 0).any()


def test_driver_takes_pala_and_rat_paths(roots, tmp_path):
    """The refusal of PALA and rat data is gone; mesh_sp > 1 is still
    refused for them (ROADMAP A.6c, ``tests/test_torch_cli_mesh_sp.py``)."""
    assert pmain.dataset_kind(str(roots["pala"])) == "pala"
    assert pmain.dataset_kind(str(roots["rat"])) == "rat"
    assert "pala" not in pmain._LATER and "mesh_sp" in pmain._LATER
    assert pmain.unet_layers("pala") == pmain.unet_layers("rat") == 10
    assert pmain.unet_layers("chirp") == 2
