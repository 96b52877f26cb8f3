"""The port's ops (stofnet_tpu_torch.ops) against the JAX package's, on the
CPU, exactly: decode incl. tied rows, rows with more survivors than slots
and all-zero rows; the sample shuffle; max-pool + leaky."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from stofnet_tpu.ops import peaks as jpeaks
from stofnet_tpu.ops import poolgrad as jpool
from stofnet_tpu.ops import shuffle as jshuffle
from stofnet_tpu_torch.ops import peaks, poolgrad, shuffle


def _scores(rng):
    """(8, 400) heatmap rows covering the decode's corner cases."""
    s = rng.standard_normal((8, 400)).astype(np.float32)
    s[1] = 0.0  # all-zero row
    s[2] = 0.0
    s[2, 10::30] = 1.0  # 13 exactly tied maxima, spaced beyond the window
    s[3] = np.abs(s[3])
    s[3, 5::25] = np.linspace(2.0, 3.0, 16)  # 16 distinct survivors > 8
    s[4] = -np.abs(s[4])  # negative detections must beat the empty slots
    s[5, 100:110] = 5.0  # a plateau: ties inside one NMS window
    s[6, 0] = s[6, -1] = 9.0  # maxima at both ends (-inf padding)
    return s


@pytest.mark.parametrize("window", [20, 7, 1])
def test_nms1d_matches_jax(rng, window):
    s = _scores(rng)
    got = peaks.nms1d(torch.from_numpy(s), window).numpy()
    np.testing.assert_array_equal(got,
                                  np.asarray(jpeaks.nms1d(jnp.asarray(s),
                                                          window)))


@pytest.mark.parametrize("threshold", [None, 0.0, 0.5])
def test_threshold_scores_matches_jax(rng, threshold):
    s = _scores(rng)
    got = peaks.threshold_scores(torch.from_numpy(s), threshold).numpy()
    ref = np.asarray(jpeaks.threshold_scores(jnp.asarray(s), threshold))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("threshold,up,max_echoes",
                         [(None, 4, 8), (0.5, 4, 8), (0.5, 1, 64),
                          (None, 1, 3)])
def test_mask2coords_matches_jax(rng, threshold, up, max_echoes):
    s = _scores(rng)
    got = peaks.mask2coords(torch.from_numpy(s)[:, None], 20, threshold, up,
                            max_echoes).numpy()
    ref = np.asarray(jpeaks.mask2coords(jnp.asarray(s)[:, None], 20,
                                        threshold, up, max_echoes))
    assert got.dtype == np.float32 and got.shape == (8, max_echoes)
    np.testing.assert_array_equal(got, ref)
    # the tied row keeps its lowest-index members, as lax.top_k does
    if threshold is None and max_echoes == 8:
        np.testing.assert_array_equal(got[2], np.arange(10, 250, 30) / up)


def test_batch_mask2coords_matches_jax(rng):
    s = _scores(rng).reshape(2, 4, 400)
    got = peaks.batch_mask2coords(torch.from_numpy(s), 20, 0.5, 4, 8).numpy()
    ref = np.asarray(jpeaks.batch_mask2coords(jnp.asarray(s), 20, 0.5, 4, 8))
    np.testing.assert_array_equal(got, ref)


def test_coords2mask_and_amplitudes_match_jax(rng):
    samples = np.array([[0.0, 3.7, 12.0, -4.0, 99.0, 100.0, 250.0],
                        [5.5, 5.5, 1.0, 0.0, 0.0, 64.49, 64.5]], np.float32)
    got = peaks.coords2mask(torch.from_numpy(samples), 100).numpy()
    ref = np.asarray(jpeaks.coords2mask(jnp.asarray(samples), 100))
    np.testing.assert_array_equal(got, ref)

    frames = rng.standard_normal((2, 100)).astype(np.float32)
    got = peaks.get_amplitudes(torch.from_numpy(frames),
                               torch.from_numpy(samples)).numpy()
    ref = np.asarray(jpeaks.get_amplitudes(jnp.asarray(frames),
                                           jnp.asarray(samples)))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("r,c", [(4, 1), (2, 3), (1, 2)])
def test_sample_shuffle_matches_jax(rng, r, c):
    x = rng.standard_normal((2, r * c, 50)).astype(np.float32)
    got = shuffle.sample_shuffle(torch.from_numpy(x), r).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jshuffle.sample_shuffle(jnp.asarray(x), r)))
    back = shuffle.sample_unshuffle(torch.from_numpy(got), r).numpy()
    np.testing.assert_array_equal(back, x)
    np.testing.assert_array_equal(
        back, np.asarray(jshuffle.sample_unshuffle(jnp.asarray(got), r)))


@pytest.mark.parametrize("length", [800, 845])
def test_maxpool_leaky_matches_jax(rng, length):
    y = rng.standard_normal((2, length, 16)).astype(np.float32)
    got = poolgrad.maxpool_leaky(torch.from_numpy(y), 80, 0.01).numpy()
    ref = np.asarray(jpool.maxpool_leaky(jnp.asarray(y), 80, 0.01))
    assert got.shape == (2, length // 80, 16)
    np.testing.assert_array_equal(got, ref)
