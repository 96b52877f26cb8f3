"""The two helpers neither package's runtime calls, in the port against
JAX: ``ops/hilbert.hilbert_transform_features`` (the reference's
HilbertTransform module; JAX's test ``tests/test_aux.py:124``) and
``utils/config.convert_to_dot_notation``. The envelope agrees to f32 FFT
rounding (rtol 1e-5, atol 1e-5 of the largest); the concatenated
oscillation is the input bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stofnet_tpu.ops.hilbert import (
    hilbert_transform_features as jax_features,
)
from stofnet_tpu.utils.config import (
    convert_to_dot_notation as jax_convert,
)
from stofnet_tpu_torch.ops.hilbert import hilbert_transform_features
from stofnet_tpu_torch.utils.config import Config, convert_to_dot_notation


@pytest.mark.parametrize("concat,length", [(False, 128), (True, 128),
                                           (True, 101)])
def test_hilbert_transform_features_matches_jax(concat, length):
    x = np.random.default_rng(length).standard_normal(
        (2, 3, length)).astype(np.float32)
    want = np.asarray(jax_features(jnp.asarray(x), concat_oscil=concat))
    got = hilbert_transform_features(torch.from_numpy(x),
                                     concat_oscil=concat).numpy()
    assert got.shape == want.shape == ((2, 6 if concat else 3, length))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    if concat:
        np.testing.assert_array_equal(got[:, 3:], x)


def test_convert_to_dot_notation_matches_jax():
    d = {"model": "stofnet", "lr": 5e-4, "mesh_sp": 2, "th": None}
    got, want = convert_to_dot_notation(d), jax_convert(d)
    assert isinstance(got, Config) and dict(got) == dict(want) == d
    assert got.model == want.model and got.mesh_sp == want.mesh_sp == 2
    got.lr = 1e-3
    assert got["lr"] == 1e-3 and d["lr"] == 5e-4
    with pytest.raises(AttributeError):
        got.missing
