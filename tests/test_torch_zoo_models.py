"""The port's model zoo (``stofnet_tpu_torch/models/{edsr1d,espcn1d,zonzini,
wave_unet,kuleshov,sincnet,gradpeak,registry}.py``) and its signal ops
against the JAX package's, on the CPU (their signal ops:
``tests/test_torch_zoo_ops.py``).

Weights come from each JAX module's ``init`` and cross through
``registry.variables_to_state_dict``; inputs are made by numpy from a
seed. Tolerances:
- f32 forwards, heatmap and regression: rtol 1e-4, atol 1e-5 * max|ref|;
  SincNet (k=1023 sums): rtol 2e-3, atol 1e-3 * max|ref|;
- bf16 pipelines: >= 0.99 of the decoded slots within 1 sample of JAX's.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stofnet_tpu.models import build_model as jbuild
from stofnet_tpu.models.registry import export_checkpoint as jexport
from stofnet_tpu.serve import make_pipeline as jpipeline
from stofnet_tpu_torch.data.synthetic import gate_batch
from stofnet_tpu_torch.models import (
    MODEL_NAMES, build_model, export_checkpoint, import_checkpoint,
    variables_to_state_dict,
)
from stofnet_tpu_torch.models.batchnorm import BatchNorm
from stofnet_tpu_torch.serve import make_pipeline, probe_dtype_agreement

ZOO = ("edsr", "espcn", "zonzini", "unet", "sincnet", "kuleshov")
BN = ("unet", "sincnet", "kuleshov")
FS = 1e6
# registry arguments at a small size; the unet's input is rf * up longer
OV = dict(dataset_kind="chirp", upsample_factor=4, sample_num=200,
          rf_scale_factor=4, fs=FS)
LENGTH = {"zonzini": 1600}  # 4 stages of at least 12


def length_of(name):
    return LENGTH.get(name, OV["sample_num"] * OV["rf_scale_factor"])


@functools.lru_cache(maxsize=None)
def jax_model(name, seed=1):
    """(JAX module, its variables, the port's state dict of them)."""
    model, _ = jbuild(name, **OV)
    variables = jax.jit(model.init)(jax.random.key(seed),
                                    jnp.zeros((1, 1, length_of(name))))
    sd = variables_to_state_dict(name, variables)
    return model, variables, {k: torch.from_numpy(np.array(v))
                              for k, v in sd.items()}


def port_model(name, state, dtype=None):
    model, _ = build_model(name, dtype=dtype, device="cpu", **OV)
    model.load_state_dict(state, strict=True)
    return model


def tol(name):
    return (2e-3, 1e-3) if name == "sincnet" else (1e-4, 1e-5)


@pytest.mark.parametrize("name,train", [(n, False) for n in ZOO]
                         + [("unet", True), ("sincnet", True)])
def test_forward_matches_jax(name, train, rng):
    """f32, eval mode (running statistics) and, for the BatchNorm families
    without dropout, train mode (batch statistics)."""
    jm, variables, state = jax_model(name)
    x = rng.standard_normal((3, 1, length_of(name))).astype(np.float32)
    if train:
        ref, _ = jax.jit(lambda v, x: jm.apply(v, x, train=True,
                                               mutable=["batch_stats"]))(
            variables, jnp.asarray(x))
    else:
        ref = jax.jit(jm.apply)(variables, jnp.asarray(x))
    ref = np.asarray(ref)
    model = port_model(name, state).train(train)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    rtol, atol = tol(name)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=atol * np.abs(ref).max())


def test_gradpeak_forward_matches_jax(rng):
    jm, _ = jbuild("gradpeak", th=None, **OV)
    pm, _ = build_model("gradpeak", th=None, device="cpu", **OV)
    x = gate_batch(6, length_of("gradpeak"), rng)
    ref = np.asarray(jax.jit(lambda x: jm.apply({}, x))(jnp.asarray(x)))
    got = pm.apply({}, torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (6, 1) and (ref > 0).all()
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("name", ZOO + ("gradpeak",))
def test_bf16_pipeline_decodes_as_jax(name, rng):
    """``make_pipeline(model_name=)`` in bf16 against JAX's: >= 0.99 of
    the slots within 1 sample (bf16 rounds where JAX's module does, the
    sums' order differs)."""
    length = length_of(name)
    if name == "gradpeak":
        variables, state = {}, {}
    else:
        _, variables, state = jax_model(name)
    x = gate_batch(8, length, rng)
    ref = np.asarray(jax.jit(jpipeline(variables, OV, model_name=name,
                                       dtype=jnp.bfloat16, max_echoes=8))(
        jnp.asarray(x)))
    pipe = make_pipeline(state, OV, model_name=name, dtype=torch.bfloat16,
                         max_echoes=8, device="cpu")
    got = pipe(x).numpy()
    assert got.shape == ref.shape
    assert pipe.calls == {"module": 1} and pipe.route(length) == "module"
    assert np.mean(np.abs(got - ref) <= 1.0) >= 0.99


@pytest.mark.parametrize("name", ["edsr", "zonzini", "unet", "gradpeak"])
def test_f32_pipeline_matches_jax_and_probe_runs(name, rng):
    length = length_of(name)
    if name == "gradpeak":
        variables, state = {}, {}
    else:
        _, variables, state = jax_model(name)
    x = gate_batch(4, length, rng)
    ref = np.asarray(jax.jit(jpipeline(variables, OV, model_name=name,
                                       dtype=jnp.float32, max_echoes=8))(
        jnp.asarray(x)))
    got = make_pipeline(state, OV, model_name=name, dtype=torch.float32,
                        max_echoes=8, device="cpu")(x).numpy()
    if name == "zonzini":
        np.testing.assert_allclose(got, ref, rtol=1e-4,
                                   atol=1e-5 * np.abs(ref).max())
    else:
        assert np.mean(np.abs(got - ref) <= 1.0) == 1.0
    agree = probe_dtype_agreement(state, OV, length=length, model_name=name,
                                  batch=4, max_echoes=8, device="cpu")
    assert 0.0 <= agree <= 1.0


def test_zoo_pipeline_refuses_int8():
    with pytest.raises(ValueError, match="stofnet only"):
        make_pipeline({}, OV, model_name="gradpeak", device="cpu",
                      int8_calib=np.zeros((1, 1, 800), np.float32))


def test_zonzini_rejects_short_input():
    model, _ = build_model("zonzini", device="cpu")
    with pytest.raises(ValueError, match="< 12"):
        model(torch.zeros(1, 1, 400))


@pytest.mark.parametrize("name", ZOO)
def test_state_dict_round_trip_through_reference_pth(name, tmp_path):
    """JAX's ``export_checkpoint`` .pth loads strictly through the port's
    ``import_checkpoint``, equal to ``variables_to_state_dict``; the port's
    ``export_checkpoint`` writes the same tensors back."""
    _, variables, state = jax_model(name)
    jexport(name, variables, str(tmp_path / "jax.pth"))
    got = import_checkpoint(name, tmp_path / "jax.pth")
    assert got.keys() == state.keys()
    model = port_model(name, got)
    export_checkpoint(name, model.state_dict(), tmp_path / "port.pth")
    again = torch.load(tmp_path / "port.pth", weights_only=True)
    for k, v in state.items():
        assert torch.equal(got[k], v), k
        assert torch.equal(again[k], v), k


def test_import_checkpoint_holds_unet_depth(tmp_path):
    _, variables, _ = jax_model("unet")
    jexport("unet", variables, str(tmp_path / "u.pth"))
    with pytest.raises(ValueError, match="n_layers=3"):
        import_checkpoint("unet", tmp_path / "u.pth", n_layers=3)


def test_registry_updates_and_fresh_draws_are_seeded():
    assert MODEL_NAMES == ("stofnet", "zonzini", "kuleshov", "edsr",
                           "espcn", "sincnet", "unet", "gradpeak")
    ups = {n: build_model(n, device="meta", **OV)[1] for n in MODEL_NAMES}
    assert ups["sincnet"] == {"upsample_factor": 1}
    assert ups["unet"] == {"rf_scale_factor": 16, "upsample_factor": 1}
    assert ups["gradpeak"] == {"evaluate": True}
    for n in ("edsr", "kuleshov"):
        a, b = (build_model(n, device="cpu", **OV,
                            generator=torch.Generator().manual_seed(5))[0]
                for _ in range(2))
        for k, v in a.state_dict().items():
            assert torch.equal(v, b.state_dict()[k]), k
    with pytest.raises(ValueError, match="unknown model"):
        build_model("vit", device="cpu")


@pytest.mark.parametrize("name,count", [
    ("edsr", 210_289), ("espcn", 6_948), ("zonzini", 134_481),
    ("unet", 37_762), ("sincnet", 329_859), ("kuleshov", 1_248_578_050)])
def test_parameter_counts_at_the_chirp_widths(name, count):
    """At the driver's chirp configuration (800 IQ samples, rf 10): the
    JAX package's counts."""
    model, _ = build_model(name, sample_num=800, rf_scale_factor=10, fs=FS,
                           device="meta")
    assert sum(p.numel() for p in model.parameters()) == count


def test_fresh_init_follows_the_torch_default_scheme():
    """U(+-1/sqrt(fan_in)) for the weights and biases (ESPCN: its own
    normal draws and zero biases); BatchNorm at 1, 0, 0, 1."""
    model, _ = build_model("unet", device="cpu",
                           generator=torch.Generator().manual_seed(0))
    w = model.encoder[1].main[0].weight  # k15, 16 in
    bound = 1 / np.sqrt(15 * 16)
    assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound
    bn = model.encoder[0].main[1]
    assert torch.equal(bn.weight, torch.ones(16))
    assert torch.equal(bn.running_var, torch.ones(16))
    espcn, _ = build_model("espcn", device="cpu",
                           generator=torch.Generator().manual_seed(0))
    assert not espcn.conv1.bias.any()
    assert espcn.conv3.weight.std() < 3e-3


def test_batchnorm_updates_with_the_biased_variance(rng):
    """flax's update, ``ra = m * ra + (1 - m) * stat`` with the biased
    variance; ``nn.BatchNorm1d``'s unbiased one differs by N/(N-1)."""
    x = torch.from_numpy(rng.standard_normal((2, 50, 4)).astype(np.float32))
    bn = BatchNorm(4).train()
    bn(x)
    var = x.reshape(-1, 4).var(0, unbiased=False)
    np.testing.assert_allclose(bn.running_var, 0.9 + 0.1 * var, rtol=1e-6)
    np.testing.assert_allclose(bn.running_mean, 0.1 * x.reshape(-1, 4).mean(0),
                               rtol=1e-5, atol=1e-7)
    ref = torch.nn.BatchNorm1d(4).train()
    ref(x.transpose(1, 2))
    assert not torch.allclose(bn.running_var, ref.running_var, rtol=1e-5)
