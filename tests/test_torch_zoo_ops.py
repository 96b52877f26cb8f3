"""The port's signal ops of the model zoo (``stofnet_tpu_torch/ops/
{resample,hilbert,gradpeak}.py``) against the JAX package's, on the CPU,
on inputs made by numpy from a seed: ``toa_detect``, ``hilbert_envelope``
and the resampling ops within 1e-5, at an odd and an even length, and the
tie rules of the detector's rankings.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stofnet_tpu.ops import gradpeak as jgp
from stofnet_tpu.ops import hilbert as jhil
from stofnet_tpu.ops import resample as jres
from stofnet_tpu_torch.data.synthetic import gate_batch
from stofnet_tpu_torch.ops import gradpeak, hilbert, resample


@pytest.mark.parametrize("length", [999, 1000])
def test_hilbert_envelope_matches_jax(length, rng):
    x = rng.standard_normal((3, length)).astype(np.float32)
    ref = np.asarray(jhil.hilbert_envelope(jnp.asarray(x)))
    got = hilbert.hilbert_envelope(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    ref_t = np.asarray(jhil.hilbert_envelope(jnp.asarray(x.T), axis=0))
    got_t = hilbert.hilbert_envelope(torch.from_numpy(x.T.copy()), axis=0)
    np.testing.assert_allclose(got_t.numpy(), ref_t, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("length", [1999, 2000])
@pytest.mark.parametrize("threshold", [None, 1e-3])
def test_toa_detect_matches_jax(length, threshold, rng):
    """The detector on echo-bearing rows with its auto threshold and a
    fixed one, each echo's (onset, peak, amplitude) and the pruned
    table."""
    x = gate_batch(6, length, rng)[:, 0]
    for kw in (dict(rescale_factor=4, max_echoes=16),
               dict(rescale_factor=10, echo_max=1, max_echoes=64)):
        ref = np.asarray(jax.jit(lambda x: jgp.toa_detect(
            x, threshold=threshold, **kw))(jnp.asarray(x)))
        got = gradpeak.toa_detect(torch.from_numpy(x), threshold=threshold,
                                  **kw).numpy()
        assert got.shape == ref.shape
        assert (ref[..., 1] > 0).any()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_gradpeak_ops_tie_rules():
    """Equal amplitudes keep the lower index first (lax.top_k), the first
    True positions come out ascending with the sentinel after them."""
    mask = torch.tensor([[False, True, False, True, True]])
    assert gradpeak._first_indices(mask, 4).tolist() == [[1, 3, 4, 2 ** 30]]
    key = torch.tensor([[1.0, 3.0, 3.0, 3.0, 0.0]])
    assert gradpeak._top(key, 2).tolist() == [[1, 2]]
    echoes = torch.tensor([[[1.0, 9.0, 0.5], [2.0, 4.0, 0.5],
                            [3.0, 6.0, 0.5]]])
    ref = np.asarray(jgp.reduce_echoes(jnp.asarray(echoes.numpy()), 2))
    np.testing.assert_array_equal(gradpeak.reduce_echoes(echoes, 2), ref)
    y = np.random.default_rng(0).standard_normal((2, 50)).astype(np.float32)
    np.testing.assert_allclose(
        gradpeak.gradient1d(torch.from_numpy(y), 3.0),
        np.asarray(jgp.gradient1d(jnp.asarray(y), 3.0)), rtol=1e-6)
    np.testing.assert_allclose(
        gradpeak.gaussian_smooth(torch.from_numpy(y), 1.5),
        np.asarray(jgp.gaussian_smooth(jnp.asarray(y), 1.5)),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("axis", [-1, 1])
def test_resample_ops_match_jax(axis, rng):
    x = rng.standard_normal((2, 37, 3)).astype(np.float32)
    ref = np.asarray(jres.linear_resample(jnp.asarray(x), 74, axis=axis))
    got = resample.linear_resample(torch.from_numpy(x), 74, axis=axis)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        resample.upscale_1d(torch.from_numpy(x), 2.5, axis=axis).numpy(),
        np.asarray(jres.upscale_1d(jnp.asarray(x), 2.5, axis=axis)),
        rtol=1e-6, atol=1e-6)
    iq = (rng.standard_normal((2, 40))
          + 1j * rng.standard_normal((2, 40))).astype(np.complex64)
    np.testing.assert_allclose(
        resample.iq2rf(torch.from_numpy(iq), 120e3, 1e6, 10).numpy(),
        np.asarray(jres.iq2rf(jnp.asarray(iq), 120e3, 1e6, 10)),
        rtol=1e-5, atol=1e-5)
