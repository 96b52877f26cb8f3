"""The rest of the model zoo: ``stofnet_tpu_torch/models/sincnet_full.py``
(SincNetFull and SincMLP over the reference's option space),
``models/attention.py`` (AttentionBlock1D) and Kuleshov away from 4
layers, against the JAX package's modules on the CPU.

Weights come from each flax module's ``init`` and cross through the port's
converters (``sincnet_full.state_from_flax``, ``attention.state_from_flax``,
``registry.variables_to_state_dict``); inputs are made by numpy from a
seed. Tolerance in f32: rtol 2e-3, atol 2e-4 * max|ref| (the JAX
package's own SincNet golden tolerance).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stofnet_tpu.models.attention import AttentionBlock1D as JAttention
from stofnet_tpu.models.kuleshov import Kuleshov as JKuleshov
from stofnet_tpu.models.sincnet_full import MLP as JMLP
from stofnet_tpu.models.sincnet_full import SincNetFull as JSincNetFull
from stofnet_tpu_torch.models import attention, sincnet_full
from stofnet_tpu_torch.models.kuleshov import Kuleshov
from stofnet_tpu_torch.models.registry import variables_to_state_dict


def _close(got, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=2e-3,
                               atol=2e-4 * max(np.abs(ref).max(), 1e-6))


CNN = {
    # max-pool strides, relu/tanh/elu, an even kernel (asymmetric pad, the
    # sinc conv forced odd), dropout in eval, BatchNorm everywhere
    "pool_acts_sinc": {
        "input_dim": 512, "fs": 25e6,
        "cnn_N_filt": [32, 24, 16, 8], "cnn_len_filt": [129, 11, 9, 6],
        "cnn_max_pool_len": [2, 2, 1, 1],
        "cnn_use_laynorm_inp": False, "cnn_use_batchnorm_inp": False,
        "cnn_use_laynorm": [False] * 4, "cnn_use_batchnorm": [True] * 4,
        "cnn_act": ["relu", "tanh", "elu", "linear"],
        "cnn_drop": [0.1, 0.1, 0.0, 0.0], "use_sinc": True},
    # no sinc, log-softmax over channels, input BatchNorm, pool 4 at a
    # length it does not divide
    "no_sinc_softmax_input_bn": {
        "input_dim": 254, "fs": 25e6,
        "cnn_N_filt": [16, 12, 4], "cnn_len_filt": [31, 9, 7],
        "cnn_max_pool_len": [4, 2, 1],
        "cnn_use_laynorm_inp": False, "cnn_use_batchnorm_inp": True,
        "cnn_use_laynorm": [False] * 3, "cnn_use_batchnorm": [False] * 3,
        "cnn_act": ["leaky_relu", "softmax", "sigmoid"],
        "cnn_drop": [0.0, 0.2, 0.0], "use_sinc": False},
    "input_laynorm": {
        "input_dim": 200, "fs": 25e6,
        "cnn_N_filt": [8, 4], "cnn_len_filt": [15, 5],
        "cnn_max_pool_len": [1, 1],
        "cnn_use_laynorm_inp": True, "cnn_use_batchnorm_inp": False,
        "cnn_use_laynorm": [False, False], "cnn_use_batchnorm": [False] * 2,
        "cnn_act": ["relu", "linear"], "cnn_drop": [0.0, 0.0],
        "use_sinc": False},
    # the path broken upstream, as the JAX docstring defines it: |h| at
    # layer 0, the pool, RefLayerNorm((C, L_pooled)); ln wins over bn
    "cnn_laynorm": {
        "input_dim": 130, "fs": 25e6,
        "cnn_N_filt": [8, 4], "cnn_len_filt": [65, 5],
        "cnn_max_pool_len": [2, 1],
        "cnn_use_laynorm_inp": False, "cnn_use_batchnorm_inp": False,
        "cnn_use_laynorm": [True, True], "cnn_use_batchnorm": [False, True],
        "cnn_act": ["leaky_relu", "linear"], "cnn_drop": [0.0, 0.0],
        "use_sinc": True},
    # layer and input BatchNorm in train mode (no dropout)
    "train_bn": {
        "input_dim": 128, "fs": 25e6,
        "cnn_N_filt": [8, 4], "cnn_len_filt": [33, 5],
        "cnn_max_pool_len": [3, 1],
        "cnn_use_laynorm_inp": False, "cnn_use_batchnorm_inp": True,
        "cnn_use_laynorm": [False, False], "cnn_use_batchnorm": [True, True],
        "cnn_act": ["leaky_relu", "linear"], "cnn_drop": [0.0, 0.0],
        "use_sinc": True},
}

MLP_BASE = {
    "input_dim": 48, "fc_lay": [48, 32, 16], "fc_drop": [0.15, 0.0, 0.0],
    "fc_use_laynorm": [True, False, False],
    "fc_use_batchnorm": [False, True, False],
    "fc_use_laynorm_inp": True, "fc_use_batchnorm_inp": False,
    "fc_act": ["leaky_relu", "tanh", "linear"],
}
MLP = {
    "mixed_norms": MLP_BASE,
    # both norms on: the second branch applies wx again (equal widths)
    "both_norms_quirk": dict(MLP_BASE, **{
        "input_dim": 32, "fc_lay": [32, 32], "fc_drop": [0.0, 0.0],
        "fc_use_laynorm": [True, True], "fc_use_batchnorm": [True, True],
        "fc_use_laynorm_inp": False, "fc_use_batchnorm_inp": True,
        "fc_act": ["relu", "linear"]}),
    "elu_sigmoid_softmax": dict(MLP_BASE, **{
        "fc_use_laynorm": [False] * 3, "fc_use_batchnorm": [False] * 3,
        "fc_use_laynorm_inp": False,
        "fc_act": ["elu", "sigmoid", "softmax"]}),
    "train_bn": dict(MLP_BASE, **{
        "fc_drop": [0.0] * 3, "fc_use_batchnorm_inp": True,
        "fc_use_batchnorm": [True, True, False]}),
}


def _pair(options, x, mlp, seed=0):
    """(flax module, its variables, the port's module on their state)."""
    jm = (JMLP if mlp else JSincNetFull)(options)
    variables = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    if "batch_stats" in variables:
        # statistics away from their init, so eval mode reads them
        rng = np.random.default_rng(seed + 1)
        variables["batch_stats"] = jax.tree_util.tree_map(
            lambda v: (v + rng.uniform(0.1, 0.5, v.shape)).astype(
                np.float32), variables["batch_stats"])
    port = (sincnet_full.SincMLP if mlp else sincnet_full.SincNetFull)(
        options, device="cpu")
    port.load_state_dict(sincnet_full.state_from_flax(variables, options,
                                                      mlp=mlp), strict=True)
    return jm, variables, port


def _check(options, x, mlp, train):
    jm, variables, port = _pair(options, x, mlp)
    port.train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    if train:
        ref, mutated = jm.apply(variables, jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
        state = port.state_dict()
        moved = sincnet_full.state_from_flax(
            {"params": variables["params"], **mutated}, options, mlp=mlp)
        for k, v in moved.items():
            if "running" in k:
                np.testing.assert_allclose(state[k].numpy(), v.numpy(),
                                           rtol=1e-5, atol=1e-6)
        assert any("running" in k for k in moved)
    else:
        ref = jm.apply(variables, jnp.asarray(x))
    _close(got, ref)


@pytest.mark.parametrize("name", sorted(CNN))
def test_sincnet_full_matches_jax(name, rng):
    options = CNN[name]
    x = rng.standard_normal((3, options["input_dim"])).astype(np.float32)
    _check(options, x, mlp=False, train=name.startswith("train"))


@pytest.mark.parametrize("name", sorted(MLP))
def test_sinc_mlp_matches_jax(name, rng):
    options = MLP[name]
    x = rng.standard_normal((4, options["input_dim"])).astype(np.float32)
    _check(options, x, mlp=True, train=name.startswith("train"))


def test_sincnet_full_takes_a_channel_input(rng):
    """(B, 1, L) and (B, L) give the same (B, 1, C * L') output."""
    options = CNN["input_laynorm"]
    x = rng.standard_normal((2, options["input_dim"])).astype(np.float32)
    _, _, port = _pair(options, x, mlp=False)
    port.eval()
    with torch.no_grad():
        a = port(torch.from_numpy(x))
        b = port(torch.from_numpy(x[:, None]))
    assert a.shape == (2, 1, 4 * 200)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_sincnet_full_fresh_draw_follows_the_reference_init():
    """A fresh module: the sinc filters' mel init, LayerNorm gamma 1 beta
    0, the MLP's bounded uniform weights with zero biases, and the same
    bits from the same seed."""
    o = MLP["mixed_norms"]
    a, b = (sincnet_full.SincMLP(o, device="cpu",
                                 generator=torch.Generator().manual_seed(3))
            for _ in range(2))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    w = a.wx[1].weight
    bound = np.sqrt(0.01 / (48 + 32))
    with torch.no_grad():
        assert float(w.abs().max()) <= bound and float(w.std()) > bound / 3
        assert float(a.wx[1].bias.abs().max()) == 0.0
    assert torch.equal(a.ln0.gamma, torch.ones(48))
    cnn = sincnet_full.SincNetFull(CNN["pool_acts_sinc"], device="cpu")
    jm = JSincNetFull(CNN["pool_acts_sinc"])
    jv = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 512)))
    np.testing.assert_allclose(
        cnn.conv[0].low_hz_.detach().numpy(),
        np.asarray(jv["params"]["conv0"]["low_hz_"]), rtol=1e-6)


@pytest.mark.parametrize("length,pool", [(40, 1), (37, 4), (42, 5)])
def test_attention_block_matches_jax(length, pool, rng):
    """f32, the pool > 1 path at L % pool != 0 (the dropped tail, the
    repeat and the pad with pad // 2 in front)."""
    jm = JAttention(features=16, num_heads=4, pool=pool)
    x = rng.standard_normal((2, length, 16)).astype(np.float32)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    ref = np.asarray(jm.apply(variables, jnp.asarray(x)))
    port = attention.AttentionBlock1D(16, num_heads=4, pool=pool,
                                      device="cpu")
    port.load_state_dict(attention.state_from_flax(variables), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    _close(got, ref)


def test_attention_block_fresh_draw_is_flax_lecun_normal():
    """Kernels in flax's shapes from LeCun normal truncated at 2 std,
    zero biases, the same bits from the same seed."""
    a, b = (attention.AttentionBlock1D(
        64, num_heads=4, device="cpu",
        generator=torch.Generator().manual_seed(0)) for _ in range(2))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    q = a.sdpa.query.kernel.detach()
    assert tuple(q.shape) == (64, 4, 16)
    assert tuple(a.sdpa.out.kernel.shape) == (4, 16, 64)
    assert abs(float(q.std()) - 1 / 8) < 0.01
    assert float(q.abs().max()) <= 2 / 8 / 0.8796 + 1e-6
    assert float(a.sdpa.out.bias.abs().max()) == 0.0


@pytest.mark.parametrize("num_layers", [1, 2, 3])
def test_kuleshov_other_depths_compute_what_jax_computes(num_layers, rng):
    """Below 4 layers JAX computes (the bottleneck is always 512 wide and
    the head's width follows the analytic fc_dimensions): so does the
    port, on JAX's weights."""
    n = 1000  # every stage's width positive at 1-3 layers
    jm = JKuleshov(input_length=n, output_length=n, num_layers=num_layers)
    x = rng.standard_normal((2, 1, n)).astype(np.float32)
    variables = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))
    ref = np.asarray(jm.apply(variables, jnp.asarray(x)))
    sd = variables_to_state_dict("kuleshov", variables)
    port = Kuleshov(n, n, num_layers=num_layers, device="cpu").eval()
    port.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    _close(got, ref)


def test_kuleshov_more_than_4_layers_raises_as_jax():
    """Five layers index past the 4 filter widths: JAX raises IndexError
    at init, the port at construction."""
    with pytest.raises(IndexError):
        JKuleshov(input_length=400, output_length=800, num_layers=5).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 1, 400)))
    with pytest.raises(IndexError):
        Kuleshov(400, 800, num_layers=5, device="cpu")
