"""The port's int8-SGB path (``ops/int8.py``, ``models/int8.py`` and the
int8 route of ``serve.make_pipeline``) against the JAX package's, on the
CPU, with seeded numpy inputs and weights from a JAX random init moved
across by ``params_to_state_dict``.

Tolerances:
- the s8 conv, ``quantize``, ``quantize_weight`` and the stored weight
  codes ``wq`` are held bit for bit;
- scales calibrated by an f32 forward (``pre_scale``, ``inv_eq`` and the
  weight scales of equalized kernels) to rtol 4e-6: the two packages sum
  the calibration convs' f32 products in different orders (measured up to
  1.9e-6), and XLA's and PyTorch's ``pow`` differ by up to 1 ulp;
- with ``eq_alpha`` the codes are held bit for bit wherever JAX's
  pre-rounding value lies more than 1e-3 of a code from a rounding
  boundary (the calibration's rtol moves a code of at most 127 by less);
- a bias-corrected bias to 0.1 of the largest correction: a correction
  is a mean of rounding errors over the B * L calibration positions, and
  each activation code that the calibration's summation order flips
  moves it by up to 7 * 127 / (B * L) of a product's step (measured up
  to 0.026);
- the int8 forward's heatmap in f32 to the model tests' rtol 2e-3,
  atol 2e-4 * max|heatmap|, and the pipeline's coords to 1 sample.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stofnet_tpu.models import StofNet as JaxStofNet
from stofnet_tpu.models import int8 as jint8
from stofnet_tpu.ops import int8 as jops
from stofnet_tpu.serve import make_pipeline as jax_make_pipeline
from stofnet_tpu_torch.models import int8 as tint8
from stofnet_tpu_torch.models.torch_import import params_to_state_dict
from stofnet_tpu_torch.ops import int8 as tops
from stofnet_tpu_torch.serve import make_pipeline

L, B = 800, 4
CAL_RTOL = 4e-6
TIE = 1e-3


def _state(cfg=None, length=L):
    cfg = cfg or {}
    variables = JaxStofNet(**cfg).init(jax.random.key(0),
                                       jnp.zeros((1, 1, length)))
    return variables, {k: torch.tensor(v)
                       for k, v in params_to_state_dict(variables).items()}


def _batch(rng, length=L, batch=B):
    x = rng.standard_normal((batch, 1, length)).astype(np.float32)
    return x / np.abs(x).max(axis=-1, keepdims=True)


@pytest.mark.parametrize("impl", ["conv", "dots"])
@pytest.mark.parametrize("k", [5, 7, 4])
def test_conv1d_same_int8_matches_jax(rng, k, impl):
    """Bit for bit against JAX's s8 conv and an int64 numpy conv, with
    SAME's (k-1)//2 left and k//2 right padding (k=4 splits unevenly)."""
    xq = rng.integers(-127, 128, (2, 37, 16)).astype(np.int8)
    wq = rng.integers(-127, 128, (k, 16, 24)).astype(np.int8)
    ref = np.zeros((2, 37, 24), np.int64)
    xp = np.pad(xq.astype(np.int64), ((0, 0), ((k - 1) // 2, k // 2),
                                      (0, 0)))
    for t in range(k):
        ref += xp[:, t:t + 37] @ wq[t].astype(np.int64)
    jax_out = np.asarray(jops.conv1d_same_int8(jnp.asarray(xq),
                                               jnp.asarray(wq), impl=impl))
    got = tops.conv1d_same_int8(torch.from_numpy(xq), torch.from_numpy(wq),
                                impl=impl)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), jax_out)
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int32))
    # the same on the codes laid out as quantize_weight stores them
    laid = tops._mm_layout(torch.from_numpy(wq))
    np.testing.assert_array_equal(
        tops.conv1d_same_int8(torch.from_numpy(xq), laid, impl=impl).numpy(),
        jax_out)


def test_conv1d_same_int8_refuses_unknown_impl():
    with pytest.raises(ValueError, match="impl"):
        tops.conv1d_same_int8(torch.zeros(1, 4, 2, dtype=torch.int8),
                              torch.zeros(3, 2, 2, dtype=torch.int8),
                              impl="fft")


def test_quantize_and_scales_match_jax(rng):
    """``absmax_scale`` (its zero guard included) and ``quantize`` (ties
    to even, clipped to +-127) bit for bit."""
    x = rng.standard_normal((3, 9, 5)).astype(np.float32) * 4
    x[1] = 0.0  # a dead row
    x[0, 0, :5] = [0.5, 1.5, 2.5, -0.5, -2.5]  # ties at scale 1
    for dim in (None, (1, 2), (0, 1)):
        js = np.asarray(jops.absmax_scale(
            jnp.asarray(x), axis=None if dim is None else dim))
        ts = tops.absmax_scale(torch.from_numpy(x), dim=dim).numpy()
        np.testing.assert_array_equal(ts, js)
    one = np.float32(1.0)
    np.testing.assert_array_equal(
        tops.quantize(torch.from_numpy(x), torch.tensor(one)).numpy(),
        np.asarray(jops.quantize(jnp.asarray(x), one)))
    assert float(tops.absmax_scale(torch.zeros(4, 4))) == 1.0


def test_quantize_weight_matches_jax(rng):
    """Per-output-channel codes and scales bit for bit; the codes are
    stored so the product's operand is a column-major view."""
    w = rng.standard_normal((7, 64, 48)).astype(np.float32) * 0.2
    w[:, :, 3] = 0.0  # a dead output channel
    jq, js = jops.quantize_weight(jnp.asarray(w))
    tq, ts = tops.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    mat = tq.reshape(7 * 64, 48)
    assert mat.data_ptr() == tq.data_ptr() and mat.stride() == (1, 7 * 64)


def _near_tie(k_eq, scale):
    """Where JAX's pre-rounding code value lies within TIE of a rounding
    boundary."""
    v = np.abs(np.asarray(k_eq, np.float64) / np.asarray(scale, np.float64))
    return np.abs(v - np.floor(v) - 0.5) < TIE


QUANT_CASES = [
    {},
    {"stack_layers": (4, 8, 10)},
    {"stack_layers": (4, 8, 10), "eq_alpha": 0.5, "bias_correct": True},
    {"quant_stack": True, "eq_alpha": 0.5},
]


@pytest.mark.parametrize("kw", QUANT_CASES,
                         ids=["sgb", "stack", "stack-eq-bias", "all-eq"])
def test_quantize_stofnet_matches_jax(rng, kw):
    variables, state = _state()
    x = _batch(rng)
    jq = jint8.quantize_stofnet(variables, jnp.asarray(x), **kw)
    tq = tint8.quantize_stofnet(state, torch.from_numpy(x), **kw)
    assert set(tq) == set(jq)
    for name in jq["f32"]:
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(
                tq["f32"][name][leaf].numpy(),
                np.asarray(jq["f32"][name][leaf]), err_msg=name)
    jc, tc = jq["contract"], tq["contract"]
    np.testing.assert_array_equal(tc["wq"].numpy(), np.asarray(jc["wq"]))
    np.testing.assert_array_equal(tc["wscale"].numpy(),
                                  np.asarray(jc["wscale"]))
    np.testing.assert_array_equal(tc["bias"].numpy(), np.asarray(jc["bias"]))
    np.testing.assert_allclose(tc["pre_scale"].numpy(),
                               np.asarray(jc["pre_scale"]), rtol=CAL_RTOL)
    assert set(tq.get("stack", {})) == set(jq.get("stack", {}))
    for name, jl in jq.get("stack", {}).items():
        tl = tq["stack"][name]
        assert set(tl) == set(jl), name
        wq_j, wq_t = np.asarray(jl["wq"]), tl["wq"].numpy()
        if "inv_eq" in jl:
            np.testing.assert_allclose(tl["inv_eq"].numpy(),
                                       np.asarray(jl["inv_eq"]),
                                       rtol=CAL_RTOL, err_msg=name)
            np.testing.assert_allclose(tl["wscale"].numpy(),
                                       np.asarray(jl["wscale"]),
                                       rtol=CAL_RTOL, err_msg=name)
            # JAX's equalized kernel, rebuilt from its own inv_eq
            k = np.asarray(variables["params"][name]["kernel"])
            k_eq = k * (1.0 / np.asarray(jl["inv_eq"]))[0, 0][None, :, None]
            far = ~_near_tie(k_eq, jl["wscale"])
            np.testing.assert_array_equal(wq_t[far], wq_j[far],
                                          err_msg=name)
            assert (wq_t != wq_j).sum() <= (~far).sum()
        else:
            np.testing.assert_array_equal(wq_t, wq_j, err_msg=name)
            np.testing.assert_array_equal(tl["wscale"].numpy(),
                                          np.asarray(jl["wscale"]))
        b0 = np.asarray(variables["params"][name]["bias"])
        delta = np.abs(np.asarray(jl["bias"]) - b0).max()
        np.testing.assert_allclose(tl["bias"].numpy(), np.asarray(jl["bias"]),
                                   rtol=0, atol=0.1 * delta, err_msg=name)


def test_stack_layers_out_of_range_raise():
    with pytest.raises(ValueError, match="stack_layers"):
        tint8._norm_stack_layers(False, (1, 4), 13)
    assert tint8._norm_stack_layers(False, (8, 4, 4), 13) == (4, 8)
    assert tint8._norm_stack_layers(True, None, 5) == (2, 3, 4)


def _assert_heat_close(got, ref):
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=2e-3,
                               atol=2e-4 * np.abs(ref).max())


@pytest.mark.parametrize("impl", ["conv", "dots"])
@pytest.mark.parametrize("length", [800, 840])
def test_apply_int8_matches_jax(rng, length, impl):
    """The serving default (int8 SGB only) in f32, at L % 80 == 0 and at
    an L that is not (840: 10 pooled rows, the pathway padded 20 and 20)."""
    variables, state = _state(length=length)
    x = _batch(rng, length)
    jq = jint8.quantize_stofnet(variables, jnp.asarray(x))
    tq = tint8.quantize_stofnet(state, torch.from_numpy(x))
    ref = np.asarray(jint8.stofnet_apply_int8(jq, jnp.asarray(x), dtype=None,
                                              impl=impl))
    got = tint8.stofnet_apply_int8(tq, torch.from_numpy(x), dtype=None,
                                   impl=impl).numpy()
    assert got.shape == (B, 1, 4 * length)
    _assert_heat_close(got, ref)


def test_requantize_commutes_with_maxpool(rng):
    """clip(round(v/s)) is monotone for s > 0, so the SGB pools the codes
    and dequantizes the max."""
    v = rng.standard_normal((3, 160, 4)).astype(np.float32) * 50
    v[0, 5:9, 0] = 3.14  # exact ties inside one window
    scale = torch.from_numpy(
        np.abs(v).max(axis=(0, 1), keepdims=True).astype(np.float32) / 127)
    vt = torch.from_numpy(v)
    pool_of_q = tint8._pool(tops.quantize(vt, scale), 80)
    q_of_pool = tops.quantize(tint8._pool(vt, 80), scale)
    assert torch.equal(pool_of_q, q_of_pool)


def test_int8_batch_composition_independence(rng):
    """A waveform's int8 forward does not depend on its batch neighbours:
    alone and beside a 100x louder waveform, its s8 activation codes,
    their scale and the s8 contraction give the same bits, and so does the
    served bf16 forward. (In f32 the CPU's own conv of the expand layer,
    (B, L/80, 512) -> 64, picks another algorithm at another batch size,
    1.4e-7 apart; that is PyTorch's CPU conv, not the int8 scheme.)"""
    variables, state = _state()
    x = _batch(rng, batch=2)
    x[1] *= 100.0
    q = tint8.quantize_stofnet(state, torch.from_numpy(x))
    xt = torch.from_numpy(x)
    h = torch.relu(torch.nn.functional.conv1d(
        torch.nn.functional.pad(xt, (4, 4)), state["conv1.weight"],
        state["conv1.bias"])).transpose(1, 2)
    codes_alone, scale_alone = tint8._dyn_quant(h[:1])
    codes, scale = tint8._dyn_quant(h)
    assert torch.equal(codes_alone, codes[:1])
    assert torch.equal(scale_alone, scale[:1])
    for impl in ("conv", "dots"):
        assert torch.equal(
            tops.conv1d_same_int8(codes_alone, q["contract"]["wq"], impl),
            tops.conv1d_same_int8(codes, q["contract"]["wq"], impl)[:1])
    alone = tint8.stofnet_apply_int8(q, xt[:1])
    together = tint8.stofnet_apply_int8(q, xt)[:1]
    assert torch.equal(alone, together)


@pytest.mark.parametrize("cfg", [{}, {"num_features": 32}],
                         ids=["armadillo", "features32"])
def test_int8_pipeline_matches_jax(rng, cfg):
    """The int8 route of ``make_pipeline`` in f32: the widths come from
    the weights' shapes, as JAX's take them, so a 32-feature state serves
    too; coords within 1 sample of JAX's int8 pipeline on the same
    weights and calibration batch."""
    variables, state = _state(cfg)
    calib = _batch(rng, batch=6)
    x = _batch(rng)
    ref = np.asarray(jax_make_pipeline(
        variables, cfg, dtype=jnp.float32, int8_calib=jnp.asarray(calib),
        max_echoes=8)(jnp.asarray(x)))
    pipe = make_pipeline(state, cfg, dtype=torch.float32, device="cpu",
                         int8_calib=calib, max_echoes=8)
    assert pipe.route(L) == pipe.route(L + 40) == "int8"
    got = pipe(x).numpy()
    assert pipe.calls == {"int8": 1}
    assert got.shape == ref.shape
    assert np.all(np.abs(got - ref) <= 1.0), np.abs(got - ref).max()


def test_try_int8_pipeline_matches_jax(rng, monkeypatch):
    """bench.py:try_int8_pipeline's path: calibrated on the gate batch, in
    bf16. Its heatmap lies within 4 bf16 steps of the largest value
    (2**-6 * max) of JAX's bf16 int8 forward (each layer rounds to bf16,
    so a 1-step difference compounds). The gate passes on the port's own
    decode of that forward and returns a pipe giving the same bits,
    refuses coords shifted by 2 samples, and where the "conv" form's
    product raises, the "dots" form serves the same bits."""
    from stofnet_tpu_torch.bench_paths import make_decoder, try_int8_pipeline
    from stofnet_tpu_torch.data.synthetic import gate_batch

    variables, state = _state()
    x = gate_batch(B, L, np.random.default_rng(7))
    xt = torch.from_numpy(x)
    jq = jint8.quantize_stofnet(variables, jnp.asarray(x))
    tq = tint8.quantize_stofnet(state, xt)
    heat_j = np.asarray(jint8.stofnet_apply_int8(jq, jnp.asarray(x)))
    heat_t = tint8.stofnet_apply_int8(tq, xt)
    assert np.abs(heat_t.numpy() - heat_j).max() <= 2.0 ** -6 * np.abs(
        heat_j).max()
    ref = make_decoder({})(heat_t)
    pipe = try_int8_pipeline(state, {}, xt, ref)
    assert pipe is not None and pipe.impl == "conv"
    got = pipe(state, xt)
    assert torch.equal(got, ref) and (got != 0).any()
    assert try_int8_pipeline(state, {}, xt, ref + 2.0 * (ref != 0)) is None

    real = tint8.conv1d_same_int8

    def no_conv(xq, wq, impl="conv"):
        if impl == "conv":
            raise RuntimeError("integer GEMM refused")
        return real(xq, wq, impl)
    monkeypatch.setattr(tint8, "conv1d_same_int8", no_conv)
    pipe = try_int8_pipeline(state, {}, xt, ref)
    assert pipe is not None and pipe.impl == "dots"
    assert torch.equal(pipe(state, xt), ref)
