"""The PALA path of the port (``stofnet_tpu_torch/ops/svd_filter.py``,
``ops/beamform.py``, ``data/pala.py`` and ``scripts/pala_bmode_figure.py``'s
compute stages) against the JAX package's, on the CPU.

Inputs are made by numpy from a seed; datasets come from the generators
at 16 channels and 256-400 samples. Tolerances (``tests/test_ops_pala.py``
where JAX's own tests set one):
- ``svd_filter`` and ``svd_filter_db``: rtol = atol = 5e-3;
- ``das_rx_batch`` and ``das_rx_apply``, real and IQ: rtol = atol = 2e-4
  (the gather form against JAX's band matrix and its gather);
- ``bf_das_batch`` and ``bf_das``: 2e-3 dB;
- the dataset's items from a dataset written by JAX's generator (block
  lists in its ``pala_config.yaml``): bit for bit; with ``clutter_db``
  (another framework's eigh) at the SVD tolerance.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch
import yaml

from stofnet_tpu.data.pala import PalaDatasetRf as JPala
from stofnet_tpu.data.pala import generate_pala_dataset as jgenerate
from stofnet_tpu.data.transforms import AddNoise as JAddNoise
from stofnet_tpu.data.transforms import Compose as JCompose
from stofnet_tpu.data.transforms import NormalizeVol as JNormalizeVol
from stofnet_tpu.ops import beamform as jbf
from stofnet_tpu.ops import svd_filter as jsvd
from stofnet_tpu.ops.hilbert import analytic_signal as janalytic
from stofnet_tpu_torch.data import pala
from stofnet_tpu_torch.data.transforms import AddNoise, Compose, NormalizeVol
from stofnet_tpu_torch.ops import beamform, svd_filter
from stofnet_tpu_torch.ops.hilbert import analytic_signal
from stofnet_tpu_torch.scripts import pala_bmode_figure
from stofnet_tpu_torch.utils.config import read_flat_yaml

SVD_TOL = 5e-3
DAS_TOL = 2e-4
DB_TOL = 2e-3


def _ensemble(rng, dtype, shape=(10, 8, 24), clutter=10.0):
    """An ensemble with a strong static clutter component."""
    x = rng.standard_normal(shape)
    if dtype == np.complex64:
        x = x + 1j * rng.standard_normal(shape)
    static = rng.standard_normal(shape[:-1] + (1,)) * np.ones(shape)
    return (x + clutter * static).astype(dtype)


@pytest.mark.parametrize("dtype", [np.complex64, np.float32])
@pytest.mark.parametrize("lo,hi", [(4, -1), (2, 10)])
def test_svd_filter_matches_jax(lo, hi, dtype, rng):
    iq = _ensemble(rng, dtype)
    ref = np.asarray(jsvd.svd_filter(jnp.asarray(iq), lo_cut=lo, hi_cut=hi))
    got = svd_filter.svd_filter(torch.from_numpy(iq), lo, hi)
    assert got.dtype == torch.from_numpy(iq).dtype
    np.testing.assert_allclose(got.numpy(), ref, rtol=SVD_TOL, atol=SVD_TOL)


@pytest.mark.parametrize("dtype", [np.complex64, np.float32])
def test_svd_filter_db_matches_jax(dtype, rng):
    ens = _ensemble(rng, dtype, (6, 48, 12), clutter=30.0)
    ref = np.asarray(jsvd.svd_filter_db(jnp.asarray(ens), -10.0))
    got = svd_filter.svd_filter_db(torch.from_numpy(ens), -10.0).numpy()
    np.testing.assert_allclose(got, ref, rtol=SVD_TOL, atol=SVD_TOL)
    assert np.linalg.norm(got) < 0.1 * np.linalg.norm(ens)


@pytest.mark.parametrize("dtype", [np.complex64, np.float32])
def test_singular_levels_db_match_numpy_svd(dtype, rng):
    """The levels ``svd_filter_db`` thresholds are those of the Casorati
    matrix's singular values (numpy's SVD in f64). Each is held to the
    f32 eigensolver's bound on the t x t Gram, |dw| <= t eps w0, in dB:
    10 log10(e) t eps w0 / w (0.08 dB at -41 dB here, 6e-6 at 0 dB)."""
    ens = _ensemble(rng, dtype, (6, 48, 12), clutter=30.0)
    t = ens.shape[-1]
    x = np.reshape(ens.astype(np.complex128), (-1, t), order="F")
    s = np.linalg.svd(x, compute_uv=False)
    ref = 20.0 * np.log10(s / s[0])
    got = svd_filter.singular_levels_db(torch.from_numpy(ens)).numpy()
    bound = 10.0 * np.log10(np.e) * t * np.finfo(np.float32).eps \
        * 10.0 ** (-ref / 10.0)
    assert np.all(np.abs(got - ref) <= bound), (got - ref, bound)


def test_svd_filter_ignores_eigenvector_signs_and_degenerate_bases(rng):
    """The band projector, not the eigenvectors, is applied: flipped
    signs (phases) and a rotated basis inside a degenerate eigenspace
    reconstruct the same ensemble."""
    iq = _ensemble(rng, np.complex64)
    x = svd_filter._casorati(torch.from_numpy(iq))
    _, u = svd_filter._gram_eigh(x)
    phase = torch.exp(1j * torch.from_numpy(
        rng.uniform(0, 6.28, u.shape[1]).astype(np.float32)))
    for v in (u, u * phase[None, :]):
        n = (x @ v)[:, 4:-1] @ v[:, 4:-1].conj().T
        torch.testing.assert_close(svd_filter._uncasorati(n, iq.shape),
                                   svd_filter.svd_filter(
                                       torch.from_numpy(iq)),
                                   rtol=1e-4, atol=1e-4)
    # a 2-fold degenerate Gram: two orthogonal slow-time patterns of equal
    # energy; any basis of their plane projects the same
    t = 8
    a = np.zeros((20, t), np.float32)
    a[:10, 0], a[10:, 1] = 3.0, 3.0
    a[:, 2:] = 0.1 * rng.standard_normal((20, t - 2))
    ens = torch.from_numpy(a.T.reshape(t, 4, 5).transpose(2, 1, 0).copy())
    got = svd_filter.svd_filter(ens, lo_cut=2, hi_cut=t)
    ref = np.asarray(jsvd.svd_filter(jnp.asarray(ens.numpy()), lo_cut=2,
                                     hi_cut=t))
    np.testing.assert_allclose(got.numpy(), ref, rtol=SVD_TOL, atol=SVD_TOL)


def _params(k=16, n_angles=3):
    xe = (np.arange(k) - (k - 1) / 2) * 3e-4
    return beamform.BeamformParams(
        xe=xe, c=1540.0, fs=5e6, t0=0.0, f0=5e6 / 4,
        angles_list=np.deg2rad([-5.0, 0.0, 5.0])[:n_angles])


def _grid(xe):
    return np.linspace(xe[0], xe[-1], 20), np.linspace(1e-3, 8e-3, 25)


def _table(params, n, theta, iq):
    gx, gz = _grid(params.xe)
    xg, zg = np.meshgrid(gx, gz)
    jt = jbf.make_delay_table(jbf.BeamformParams(*params), theta,
                              xg.ravel(), zg.ravel(), n, iq=iq)
    pt = beamform.make_delay_table(params, theta, xg.ravel(), zg.ravel(), n,
                                   iq=iq)
    return jt, pt


def test_delay_table_is_jax_copy():
    params = _params()
    jt, pt = _table(params, 256, 0.05, True)
    for a, b in zip(jt, pt):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("iq", [True, False], ids=["iq", "real"])
def test_das_rx_batch_matches_jax(iq, rng):
    """The gather form against JAX's band-matrix form; real RF through an
    ``iq=True`` table stays real (no phase)."""
    k, n, f = 16, 256, 4
    params = _params(k)
    jt, pt = _table(params, n, 0.05, True)
    shape = (f, n, k)
    sigs = rng.standard_normal(shape).astype(np.float32)
    if iq:
        sigs = (sigs + 1j * rng.standard_normal(shape)).astype(np.complex64)
    ref = np.asarray(jbf.das_rx_batch(jnp.asarray(sigs), jt))
    got = beamform.das_rx_batch(torch.from_numpy(sigs), pt)
    assert got.is_complex() == iq
    np.testing.assert_allclose(got.numpy(), ref, rtol=DAS_TOL, atol=DAS_TOL)


@pytest.mark.parametrize("iq", [True, False], ids=["iq", "real"])
def test_das_rx_apply_and_das_rx_match_jax(iq, rng):
    k, n = 16, 256
    params = _params(k)
    jt, pt = _table(params, n, -0.05, iq)
    sig = rng.standard_normal((n, k)).astype(np.float32)
    if iq:
        sig = (sig + 1j * rng.standard_normal((n, k))).astype(np.complex64)
    ref = np.asarray(jbf.das_rx_apply(jnp.asarray(sig), jt))
    got = beamform.das_rx_apply(torch.from_numpy(sig), pt).numpy()
    np.testing.assert_allclose(got, ref, rtol=DAS_TOL, atol=DAS_TOL)
    gx, gz = _grid(params.xe)
    xg, zg = np.meshgrid(gx, gz)
    ref = np.asarray(jbf.das_rx(jnp.asarray(sig), jbf.BeamformParams(
        *params), -0.05, xg.ravel(), zg.ravel()))
    got = beamform.das_rx(torch.from_numpy(sig), params, -0.05, xg.ravel(),
                          zg.ravel()).numpy()
    np.testing.assert_allclose(got, ref, rtol=DAS_TOL, atol=DAS_TOL)


def test_bf_das_batch_and_bf_das_match_jax(rng):
    """The B-mode in dB, a silent frame's -inf raised to its finite
    minimum; each frame normalized to 0 dB."""
    k, n = 16, 256
    params = _params(k, n_angles=2)
    gx, gz = _grid(params.xe)
    sig = (rng.standard_normal((2, n, k))
           + 1j * rng.standard_normal((2, n, k))).astype(np.complex64)
    frames = np.stack([sig, 0.5 * sig])
    frames[1, :, :, :3] = 0  # silent channels: some pixels sum to 0
    jp = jbf.BeamformParams(*params)
    ref = np.asarray(jbf.bf_das_batch(jnp.asarray(frames), jp, gx, gz))
    got = beamform.bf_das_batch(torch.from_numpy(frames), params, gx, gz)
    assert got.shape == (2, 25, 20) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), ref, rtol=DB_TOL, atol=DB_TOL)
    assert float(got.amax()) == 0.0
    for compound in (True, False):
        ref = np.asarray(jbf.bf_das(jnp.asarray(sig), jp, gx, gz,
                                    compound=compound))
        got = beamform.bf_das(torch.from_numpy(sig), params, gx, gz,
                              compound=compound).numpy()
        np.testing.assert_allclose(got, ref, rtol=DB_TOL, atol=DB_TOL)


@pytest.fixture(scope="module")
def jax_written(tmp_path_factory):
    """A dataset written by JAX's generator (its YAML by PyYAML)."""
    root = tmp_path_factory.mktemp("pala") / "pala_synth"
    return jgenerate(root, n_sequences=2, n_frames=4, n_channels=16,
                     n_samples=256)


def test_config_written_by_jax_reads_in_the_port(jax_written):
    """``yaml.safe_dump`` writes block lists; the port's reader gives what
    ``yaml.safe_load`` gives."""
    text = (jax_written / "pala_config.yaml").read_text()
    assert "\n- " in text
    assert read_flat_yaml(text) == yaml.safe_load(text)


def test_generator_writes_what_jax_writes(jax_written, tmp_path):
    root = pala.generate_pala_dataset(tmp_path / "pala_synth", n_sequences=2,
                                      n_frames=4, n_channels=16,
                                      n_samples=256)
    assert (read_flat_yaml((root / "pala_config.yaml").read_text())
            == yaml.safe_load((jax_written / "pala_config.yaml").read_text()))
    for s in range(2):
        a = np.load(root / "sequences" / f"seq_{s:03d}.npz")
        b = np.load(jax_written / "sequences" / f"seq_{s:03d}.npz")
        for key in ("rf", "pos"):
            np.testing.assert_array_equal(a[key], b[key])
    assert pala.MAX_TARGETS == 32


@pytest.mark.parametrize("kw", [
    dict(rescale_factor=1, ch_gap=1),
    dict(rescale_factor=3, ch_gap=4, angle_threshold=20.0),
    dict(rescale_factor=2, ch_gap=2, temporal_filter_opt=True,
         pow_law_opt=True, train=False),
], ids=["plain", "rescaled_gated", "temporal_pow"])
@pytest.mark.parametrize("noise", [False, True], ids=["bare", "noise"])
def test_items_bit_for_bit_against_jax(kw, noise, jax_written):
    """Every item's 6-tuple, with the driver's transforms (NormalizeVol,
    AddNoise's per-item draws) or without."""
    def tf(jax_side):
        if not noise:
            return None
        if jax_side:
            return JCompose([JNormalizeVol(), JAddNoise(snr=30)])
        return Compose([NormalizeVol(), AddNoise(snr=30)])

    jd = JPala(jax_written, sequences=[0, 1], transforms=tf(True), seed=5,
               **kw)
    pd = pala.PalaDatasetRf(jax_written, sequences=[0, 1],
                            transforms=tf(False), seed=5, **kw)
    assert len(pd) == len(jd) == (6 if kw.get("temporal_filter_opt") else 8)
    assert pd.get_channel_num() == jd.get_channel_num()
    assert pd.get_sample_num() == jd.get_sample_num()
    for key in ("angles_list", "fs", "c", "wavelength", "xe"):
        assert pd.get_key(key) == jd.get_key(key)
    for i in (0, len(pd) - 1, 0):  # the second read of 0: its next draw
        got, ref = pd[i], jd[i]
        assert got[5] == ref[5] == "pala"
        for a, b in zip(got[:5], ref[:5]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_clutter_filter_items_match_jax(jax_written):
    jd = JPala(jax_written, sequences=[0], clutter_db=-6.0)
    pd = pala.PalaDatasetRf(jax_written, sequences=[0], clutter_db=-6.0)
    for i in range(len(pd)):
        np.testing.assert_allclose(pd[i][0], jd[i][0], rtol=SVD_TOL,
                                   atol=SVD_TOL)


def test_figure_stages_match_jax(tmp_path):
    """``pala_bmode_figure``'s compute stages (generator, svd_filter
    lo_cut=2 of the slow-time ensemble, analytic signal, bf_das_batch) at
    a small geometry, against the same stages in JAX."""
    root = pala.generate_pala_dataset(tmp_path / "pala_synth", n_sequences=1,
                                      n_frames=6, n_channels=16,
                                      n_samples=256, n_targets=2)
    ds = pala.PalaDatasetRf(root, sequences=[0])
    params, gx, gz = pala_bmode_figure.geometry(ds, 256, nx=20, nz=24)
    frames = pala_bmode_figure.load_frames(ds)
    filt = pala_bmode_figure.clutter_filter(torch.from_numpy(frames))
    got = pala_bmode_figure.image(filt, params, gx, gz)
    assert got.shape == (6, 24, 20)

    f, a, c, n = frames.shape
    ens = np.transpose(frames, (1, 2, 3, 0)).reshape(a * c, n, f)
    jfilt = np.asarray(jsvd.svd_filter(jnp.asarray(ens), lo_cut=2))
    jfilt = np.transpose(jfilt.reshape(a, c, n, f), (3, 0, 2, 1))
    np.testing.assert_allclose(filt.numpy(), jfilt, rtol=SVD_TOL,
                               atol=SVD_TOL * np.abs(jfilt).max())
    ref = np.asarray(jbf.bf_das_batch(
        janalytic(jnp.asarray(jfilt), axis=2),
        jbf.BeamformParams(*params), gx, gz))
    # the bright part of the image (the clutter filter's own tolerance
    # moves the noise floor's dB)
    bright = ref > -20.0
    np.testing.assert_allclose(got.numpy()[bright], ref[bright],
                               atol=0.05)
    torch.testing.assert_close(
        analytic_signal(filt, axis=2),
        torch.from_numpy(np.asarray(janalytic(jnp.asarray(filt.numpy()),
                                              axis=2))),
        rtol=1e-4, atol=1e-4)
