"""The port's serving pipeline against the JAX package's on the CPU: the
decoded coords of ``make_pipeline`` on echo-bearing gate batches, through
its fused route and its module route, the gate batch itself, and the
device rule of the entry points."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stofnet_tpu import serve as jax_serve
from stofnet_tpu.data.synthetic import gate_batch as jax_gate_batch
from stofnet_tpu.models import StofNet as JaxStofNet
from stofnet_tpu_torch import default_device
from stofnet_tpu_torch.data.synthetic import gate_batch
from stofnet_tpu_torch.models import (
    StofNet, stofnet_apply_fused, stofnet_apply_reference,
)
from stofnet_tpu_torch.models.torch_import import params_to_state_dict
from stofnet_tpu_torch.serve import (
    make_pipeline, module_coords, probe_dtype_agreement,
)


@pytest.fixture(scope="module")
def weights():
    variables = JaxStofNet().init(jax.random.key(0), jnp.zeros((1, 1, 800)))
    return variables, params_to_state_dict(variables)


def test_gate_batch_matches_jax():
    a = gate_batch(4, 800, np.random.default_rng(5))
    b = jax_gate_batch(4, 800, np.random.default_rng(5))
    assert a.shape == (4, 1, 800) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def test_pipeline_coords_match_jax(rng, weights):
    variables, state = weights
    x = gate_batch(8, 800, rng)
    ref = np.asarray(jax.jit(jax_serve.make_pipeline(
        variables, {}, window_size=20, threshold=None, max_echoes=8,
        dtype=jnp.float32))(jnp.asarray(x)))
    got = make_pipeline(state, {}, window_size=20, threshold=None,
                        max_echoes=8, dtype=torch.float32, device="cpu")(x)
    assert got.shape == ref.shape == (8, 8)
    assert np.all(np.abs(got.numpy() - ref) <= 1.0), (got, ref)
    assert np.all((got.numpy() != 0).sum(1) >= 1)


def test_pipeline_bf16_on_cpu(rng, weights):
    """bf16 on both routes: the default checkpoint at L=800 takes the
    fused forward; a num_features override, which the fused forward does
    not take, takes the StofNet module."""
    _, state = weights
    x = gate_batch(2, 800, rng)
    pipe = make_pipeline(state, {"upsample_factor": 4}, max_echoes=8,
                         device="cpu")
    got = pipe(torch.from_numpy(x))
    assert got.shape == (2, 8) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    assert pipe.calls == {"fused": 1, "module": 0}
    _, state32 = _init({"num_features": 32}, 800)
    pipe = make_pipeline(state32, {"num_features": 32}, max_echoes=8,
                         device="cpu")
    got = pipe(torch.from_numpy(x))
    assert got.shape == (2, 8) and torch.isfinite(got).all()
    assert pipe.calls == {"fused": 0, "module": 1}


def _init(cfg, length):
    variables = JaxStofNet(**cfg).init(jax.random.key(0),
                                       jnp.zeros((1, 1, length)))
    return variables, params_to_state_dict(variables)


def _jax_coords(variables, cfg, x):
    return np.asarray(jax.jit(jax_serve.make_pipeline(
        variables, cfg, window_size=20, threshold=None, max_echoes=8,
        dtype=jnp.float32))(jnp.asarray(x)))


@pytest.mark.parametrize("cfg,length", [({"semi_global_scale": 40}, 1600),
                                        ({"num_features": 32}, 800)])
def test_pipeline_module_route_matches_jax(cfg, length):
    """A checkpoint the fused forward does not compute (an SGB that pools
    40, or 32 features) is served by the StofNet module, as JAX's
    make_pipeline serves it: f32 coords within 1 sample of JAX's. The
    route is read off the pipeline's call counts, and the module is
    built only at the first call."""
    variables, state = _init(cfg, length)
    x = gate_batch(4, length, np.random.default_rng(11))
    pipe = make_pipeline(state, cfg, window_size=20, threshold=None,
                         max_echoes=8, dtype=torch.float32, device="cpu")
    assert pipe.route(length) == "module"
    assert pipe.calls == {"fused": 0, "module": 0}
    got = pipe(x).numpy()
    ref = _jax_coords(variables, cfg, x)
    assert pipe.calls == {"fused": 0, "module": 1}
    assert got.shape == ref.shape == (4, 8)
    assert np.all(np.abs(got - ref) <= 1.0), (got, ref)
    assert np.all((got != 0).sum(1) >= 1)


def test_pipeline_routes_each_length(weights):
    """One pipeline of the default checkpoint: L=1000 (not a multiple of
    80) takes the module route, L=800 the fused route; both give JAX's
    make_pipeline coords within 1 sample, in f32."""
    variables, state = weights
    pipe = make_pipeline(state, {}, window_size=20, threshold=None,
                         max_echoes=8, dtype=torch.float32, device="cpu")
    for length, route, calls in ((1000, "module", {"fused": 0, "module": 1}),
                                 (800, "fused", {"fused": 1, "module": 1})):
        x = gate_batch(4, length, np.random.default_rng(length))
        assert pipe.route(length) == route
        got = pipe(x).numpy()
        assert pipe.calls == calls
        ref = _jax_coords(variables, {}, x)
        assert got.shape == ref.shape == (4, 8)
        assert np.all(np.abs(got - ref) <= 1.0), (length, got, ref)


def test_fused_forward_refuses_other_pool_scales():
    """The SGB kernels pool a fixed 80: every fused entry point refuses
    another semi_global_scale (a departure from the JAX function, which
    serves another function there) instead of computing it wrong."""
    state = StofNet(semi_global_scale=40, device="cpu").state_dict()
    x = torch.zeros((1, 1, 1600))
    for forward, kw in ((stofnet_apply_fused, {}),
                        (stofnet_apply_fused, {"trainable": True}),
                        (stofnet_apply_reference, {})):
        with pytest.raises(ValueError, match="semi_global_scale=40"):
            forward(state, x, semi_global_scale=40, dtype=None, **kw)


def test_probe_dtype_agreement_on_cpu(weights):
    """The port's probe against the JAX package's on the same weights,
    batch and seed. Both legs run the module's forward, so the f32 legs
    decode to identical coords. The bf16 legs sum in another order (oneDNN
    against XLA), and on random weights a row's maximum lies within bf16
    noise of its runner-up, so the two move different rows: the fractions
    are held to 0.05 of each other (6 of 128 slots) and to the same
    verdict at the export gate's 0.99."""
    variables, state = weights
    for length in (800, 1600, 2000):
        x = gate_batch(16, length, np.random.default_rng(3008))
        ref32 = np.asarray(jax.jit(jax_serve.make_pipeline(
            variables, {}, max_echoes=8, dtype=jnp.float32))(jnp.asarray(x)))
        np.testing.assert_array_equal(
            module_coords(state, {}, x, torch.float32, "cpu", max_echoes=8),
            ref32)
        ref = jax_serve.probe_dtype_agreement(variables, {}, length=length,
                                              max_echoes=8)
        got = probe_dtype_agreement(state, {}, length=length, device="cpu",
                                    max_echoes=8)
        assert abs(got - ref) <= 0.05, (length, got, ref)
        assert (got >= 0.99) == (ref >= 0.99), (length, got, ref)


def test_entry_points_raise_without_a_card(weights):
    """Without device='cpu', an entry point on a machine with no GPU raises
    instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, state = weights
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_pipeline(state, {})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StofNet()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        default_device()


def test_f32_on_the_card_takes_the_module_route(weights):
    """Repair: the fused route's CUDA kernels take bfloat16 only, so
    ``make_pipeline(dtype=float32)`` on the card launched them and raised
    TypeError where JAX's f32 pipeline serves (the daemon's dtype gate
    chooses f32 when bf16 moves decodes). The route rule now sends f32 on
    a CUDA device to the StofNet module, and keeps the fused route for
    bf16 on the card and for any dtype on the CPU; JAX serves f32 at the
    operating shape's length, as the port's module route does."""
    from stofnet_tpu_torch.serve import fused_takes

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert not fused_takes({}, torch.float32, cuda)
    assert fused_takes({}, torch.bfloat16, cuda)
    assert fused_takes({"upsample_factor": 4}, torch.float32, cpu)
    assert not fused_takes({"num_features": 32}, torch.bfloat16, cuda)
    assert not fused_takes({"semi_global_scale": 40}, torch.bfloat16, cpu)
    variables, state = weights
    x = gate_batch(2, 800, np.random.default_rng(11))
    ref = _jax_coords(variables, {}, x)
    got = module_coords(state, {}, x, torch.float32, "cpu", max_echoes=8)
    assert np.all(np.abs(got - ref) <= 1.0)


@pytest.mark.parametrize("route,length", [("fused", 800), ("module", 1000),
                                          ("int8", 800)])
def test_f32_routes_compute_without_tf32(weights, monkeypatch, route,
                                         length):
    """Repair: on the card PyTorch leaves cuDNN's TF32 on by default, so
    an f32 pipeline's convs rounded their products to TF32 where JAX's f32
    pipeline sums in full f32. Every f32 route now runs its forward with
    ``torch.backends.cudnn.allow_tf32`` (and the matmul flag) False, and
    gives the caller's flags back: a spy on ``F.conv1d`` sees both off at
    every conv of the forward, after the caller set them on."""
    from stofnet_tpu_torch.ops import conv as conv_mod

    _, state = weights
    seen = []
    conv1d = conv_mod.F.conv1d

    def spy(*args, **kwargs):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return conv1d(*args, **kwargs)

    x = gate_batch(2, length, np.random.default_rng(12))
    kw = {"int8_calib": x} if route == "int8" else {}
    pipe = make_pipeline(state, {}, dtype=torch.float32, device="cpu",
                         max_echoes=8, **kw)
    assert pipe.route(length) == route
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(conv_mod.F, "conv1d", spy)
    pipe(x)
    assert seen and set(seen) == {(False, False)}
    assert torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32
