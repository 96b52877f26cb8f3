"""The port's exported artifacts (``stofnet_tpu_torch/serve.py``'s
exporter half, ``cli/export.py:main`` and ``cli/serve.py``'s ``artifact=``
branch) against the port's ``make_pipeline`` and the JAX package's
exporter, on the CPU (``device="cpu"``: the two kernels' custom ops run
their plain versions), at the full width of the different-armadillo
architecture on seeded random-init weights, B <= 8, L = 800 and 1000.

Tolerances: an artifact's coords equal the live pipeline's bit for bit
(the same graph of the same ops on the same device); against JAX's
exported f32 pipeline every coord lies within 1 sample (another order of
f32 sums, as ``test_torch_cli_serve.py`` holds the daemon)."""

import threading
import time

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stofnet_tpu.models import StofNet as JaxStofNet
from stofnet_tpu.serve import (
    _detect_input_enc as jax_detect_input_enc,
    encoded_input_specs as jax_encoded_input_specs,
    export_pipeline as jax_export_pipeline,
    load_pipeline as jax_load_pipeline,
    save_pipeline as jax_save_pipeline,
)
from stofnet_tpu_torch.cli import export as cli_export
from stofnet_tpu_torch.cli.serve import build
from stofnet_tpu_torch.data.synthetic import gate_batch
from stofnet_tpu_torch.models.torch_import import params_to_state_dict
from stofnet_tpu_torch.ops.kernels import conv1, conv_stack, sgb
from stofnet_tpu_torch.serve import (
    _detect_input_enc, encoded_input_specs, export_pipeline,
    export_pipeline_weightless, load_pipeline, make_input_encoder,
    make_pipeline, save_pipeline,
)
from stofnet_tpu_torch.serving import ServingClient
from stofnet_tpu_torch.train.checkpoint import save_checkpoint

L, L_MODULE = 800, 1000  # the fused route, and L % 80 != 0: the module's
OV = {"upsample_factor": 4}
KW = dict(device="cpu", max_echoes=8)
OPS = {"stofnet_torch.sgb_contract_pool_prepared.default",
       "stofnet_torch.conv_stack_fused_prepared.default",
       "stofnet_torch.conv1_relu_rows.default"}


@pytest.fixture(scope="module")
def weights():
    """JAX's random-init StofNet and the same weights as a torch state
    dict (``params_to_state_dict``)."""
    variables = JaxStofNet().init(jax.random.key(0), jnp.zeros((1, 1, L)))
    state = {k: torch.tensor(v)
             for k, v in params_to_state_dict(variables).items()}
    return variables, state


@pytest.fixture(scope="module")
def poly(weights, tmp_path_factory):
    """A batch-polymorphic bf16 artifact at L, saved and loaded."""
    _, state = weights
    path = tmp_path_factory.mktemp("art") / "b.pt2"
    program = export_pipeline(state, OV, "b", L, **KW)
    return program, load_pipeline(save_pipeline(path, program)), path


def _ops(artifact):
    """The kernels' custom ops in an artifact's two programs."""
    return [str(n.target) for p in (artifact.forward, artifact.decode)
            for n in p.graph.nodes
            if n.op == "call_function" and "stofnet_torch" in str(n.target)]


def _x(batch, length=L, seed=0):
    return gate_batch(batch, length, np.random.default_rng(seed))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["sgb", "stack", "conv1"])
def test_custom_ops_pass_opcheck(weights, op, dtype):
    """Schema, fake implementation (shapes and strides of the CPU
    implementation's output), and dispatch of the three ops at small
    shapes."""
    _, state = weights
    rng = np.random.default_rng(1)
    if op == "sgb":
        h = torch.from_numpy(rng.standard_normal((2, 160, 64)).astype(
            np.float32)).to(dtype)
        w = state["semi_global_block.contract_conv.weight"].permute(2, 1, 0)
        image, bias = sgb.sgb_dma_weights(
            w, state["semi_global_block.contract_conv.bias"], dtype)
        args = (h, image, bias, 0.01)
        target = torch.ops.stofnet_torch.sgb_contract_pool_prepared
    elif op == "stack":
        h = torch.from_numpy(rng.standard_normal((2, 600, 64)).astype(
            np.float32)).to(dtype)
        wts = conv_stack.stack_weights(state, dtype)
        args = (h, wts.mid, wts.mid_bias, wts.last, wts.last_bias, wts.r)
        target = torch.ops.stofnet_torch.conv_stack_fused_prepared
    else:
        x = torch.from_numpy(rng.standard_normal((2, 1, 600)).astype(
            np.float32))
        args = (x, *conv1.conv1_weights(state["conv1.weight"],
                                        state["conv1.bias"], dtype))
        target = torch.ops.stofnet_torch.conv1_relu_rows
    torch.library.opcheck(target, args)


def test_fake_op_refuses_what_the_kernel_refuses(weights):
    """The SGB op's fake implementation applies the wrapper's checks, so
    a length the kernel refuses fails in the trace."""
    _, state = weights
    w = state["semi_global_block.contract_conv.weight"].permute(2, 1, 0)
    image, bias = sgb.sgb_dma_weights(
        w, state["semi_global_block.contract_conv.bias"], torch.float32)
    with torch._subclasses.FakeTensorMode() as mode:
        h = mode.from_tensor(torch.zeros((1, 150, 64)))
        with pytest.raises(ValueError, match="L % 80"):
            torch.ops.stofnet_torch.sgb_contract_pool_prepared(
                h, mode.from_tensor(image), mode.from_tensor(bias), 0.01)


def test_fused_graph_holds_each_op_once(poly):
    program, _, _ = poly
    assert sorted(_ops(program)) == sorted(OPS)


def test_module_route_exports_without_the_ops(weights, tmp_path):
    """At L=1000 the pipeline serves the StofNet module, whose skeleton is
    built with the pipeline, not inside the trace: the program holds
    neither op and gives the live pipeline's coords."""
    _, state = weights
    program = export_pipeline(state, OV, "b", L_MODULE, **KW)
    assert _ops(program) == []
    served = load_pipeline(save_pipeline(tmp_path / "m.pt2", program))
    x = _x(3, L_MODULE)
    live = make_pipeline(state, OV, **KW)
    assert live.route(L_MODULE) == "module"
    assert torch.equal(served(x), live(x))


def test_batch_polymorphic_artifact_matches_pipeline(weights, poly):
    """One ``batch="b"`` artifact serves B = 1, 3 and 8 with the live
    pipeline's coords bit for bit."""
    _, state = weights
    _, served, _ = poly
    live = make_pipeline(state, OV, **KW)
    (spec,) = served.in_specs
    assert isinstance(spec.shape[0], str) and spec.shape[1:] == (1, L)
    assert served.input_enc == "f32" and served.device == torch.device("cpu")
    for b in (1, 3, 8):
        x = _x(b, seed=b)
        got = served(x)
        assert got.shape == (b, 8)
        assert torch.equal(got, live(x))


def test_f32_artifact_within_one_sample_of_jax(weights, tmp_path):
    """In f32 the artifact's coords lie within 1 sample of JAX's
    ``load_pipeline(export_pipeline(..., platforms=("cpu",)))`` and equal
    the port's live f32 pipeline's."""
    variables, state = weights
    program = export_pipeline(state, OV, "b", L, dtype=torch.float32, **KW)
    served = load_pipeline(save_pipeline(tmp_path / "f32.pt2", program))
    ref = jax_load_pipeline(jax_save_pipeline(
        tmp_path / "f32.jaxexp", jax_export_pipeline(
            variables, {}, "b", L, platforms=("cpu",), dtype=jnp.float32,
            max_echoes=8)))
    live = make_pipeline(state, OV, dtype=torch.float32, **KW)
    for b in (1, 3, 8):
        x = _x(b, seed=10 + b)
        got = served(x).numpy()
        want = np.asarray(ref(jnp.asarray(x)))
        assert got.shape == want.shape == (b, 8)
        assert np.all(np.abs(got - want) <= 1.0), (got, want)
        assert (got != 0).any()
        np.testing.assert_array_equal(got, live(x).numpy())


def test_fixed_batch_artifact_refuses_another_batch(weights, tmp_path):
    _, state = weights
    program = export_pipeline(state, OV, 4, L, **KW)
    served = load_pipeline(save_pipeline(tmp_path / "b4.pt2", program))
    assert served.in_specs[0].shape == (4, 1, L)
    x = _x(4)
    assert torch.equal(served(x), make_pipeline(state, OV, **KW)(x))
    with pytest.raises(Exception, match="4"):
        served(_x(3))


def test_weightless_artifact_equals_baked(weights, poly, tmp_path):
    """The weightless program, with the state as its inputs from the
    ``.weights.npz`` sidecar, gives the baked artifact's coords; its file
    holds no weights and its graph the same three ops."""
    _, state = weights
    _, baked, baked_path = poly
    program, sidecar = export_pipeline_weightless(state, OV, "b", L, **KW)
    assert sorted(_ops(program)) == sorted(OPS)
    path = save_pipeline(tmp_path / "w.pt2", program, weights=sidecar)
    with np.load(str(path) + ".weights.npz") as z:
        assert set(z.files) == set(state)
        for k in state:
            np.testing.assert_array_equal(z[k], state[k].numpy())
    assert path.stat().st_size < baked_path.stat().st_size / 2
    served = load_pipeline(path)
    assert served.in_specs[0].shape[1:] == (1, L)
    for b in (1, 5):
        x = _x(b, seed=20 + b)
        assert torch.equal(served(x), baked(x))


def test_weightless_refuses_int8(weights):
    _, state = weights
    with pytest.raises(ValueError, match="int8"):
        export_pipeline_weightless(state, OV, "b", L, int8_calib=_x(4),
                                   **KW)


@pytest.mark.parametrize("enc", ["f32", "bf16", "s16", "s8c16", "s8c8"])
def test_detect_input_enc_matches_jax(enc):
    """The encoding read back from a program's inputs is JAX's for the
    same ``input_enc``, at a fixed and a symbolic batch."""
    for batch in (4, "b"):
        examples, dynamic = encoded_input_specs(enc, batch, L)
        assert len(dynamic) == len(examples)
        want = jax_detect_input_enc(jax_encoded_input_specs(
            enc, 4 if batch == "b" else batch, L))
        assert _detect_input_enc(examples) == want


@pytest.mark.parametrize("enc", ["s16", "s8c16"])
def test_encoded_input_artifact(weights, tmp_path, enc):
    """An ``input_enc=`` artifact is recognized on load (the same
    encoding as JAX's detection), encodes f32 waveforms on the host, and
    gives the encoded live pipeline's coords bit for bit."""
    _, state = weights
    program = export_pipeline(state, OV, "b", L, input_enc=enc, **KW)
    served = load_pipeline(save_pipeline(tmp_path / f"{enc}.pt2", program))
    assert served.input_enc == enc and len(served.raw_in_specs) == 2
    assert _detect_input_enc(served.raw_in_specs) == jax_detect_input_enc(
        jax_encoded_input_specs(enc, 3, L))
    live = make_pipeline(state, OV, input_enc=enc, **KW)
    x = _x(3, seed=30)
    want = live(*make_input_encoder(enc)(x))
    assert torch.equal(served(x), want)
    assert torch.equal(served.raw_call(*served.encode(x)), want)


def test_int8_artifact_equals_int8_route(weights, tmp_path):
    """The int8 route's calibrated state is baked in: the artifact gives
    the int8 pipeline's coords at any batch."""
    _, state = weights
    calib = _x(8, seed=40)
    program = export_pipeline(state, OV, "b", L, int8_calib=calib, **KW)
    served = load_pipeline(save_pipeline(tmp_path / "i8.pt2", program))
    live = make_pipeline(state, OV, int8_calib=calib, **KW)
    for b in (1, 4):
        x = _x(b, seed=41 + b)
        assert torch.equal(served(x), live(x))


def test_load_on_another_device_raises(poly):
    """A program serves on the device it was exported for."""
    _, _, path = poly
    with pytest.raises(ValueError, match="cuda"):
        load_pipeline(path, device="cuda")
    assert load_pipeline(path, device="cpu").device == torch.device("cpu")


@pytest.fixture(scope="module")
def ckpt(weights, tmp_path_factory):
    _, state = weights
    d = tmp_path_factory.mktemp("ckpts")
    save_checkpoint(d / "armadillo-seed0.pt", state)
    return d


def test_cli_export_end_to_end(weights, ckpt, tmp_path, capsys):
    """``cli.export.main`` writes a batch-polymorphic artifact whose coords
    are the live pipeline's in the dtype its gate chose, with the summary
    line on stderr; a weightless one has its sidecar."""
    _, state = weights
    out = tmp_path / "cli.pt2"
    path = cli_export.main([f"model_file=armadillo", f"ckpt_dir={ckpt}",
                            f"length={L}", "batch=b", f"out={out}",
                            "device=cpu", "max_echoes=8"])
    err = capsys.readouterr().err
    assert path == str(out) and "dtype gate" in err
    assert "weights baked in" in err and "device=cpu" in err
    assert f"input=(b, 1, {L}) f32" in err
    dtype = torch.bfloat16 if "bf16 OK" in err else torch.float32
    x = _x(3, seed=50)
    want = make_pipeline(state, OV, dtype=dtype, **KW)(x)
    assert torch.equal(load_pipeline(path)(x), want)

    path = cli_export.main([f"model_file=armadillo", f"ckpt_dir={ckpt}",
                            f"length={L}", "batch=2", f"out={out}",
                            "device=cpu", "max_echoes=8", "dtype=bfloat16",
                            "bake_weights=False"])
    assert "sidecar" in capsys.readouterr().err
    served = load_pipeline(path)
    assert served.in_specs[0].shape == (2, 1, L)
    assert torch.equal(served(x[:2]), make_pipeline(state, OV, **KW)(x[:2]))


def test_cli_export_gates_dtype_before_the_encoding(ckpt, tmp_path,
                                                    monkeypatch):
    """As in JAX, the dtype gate probes the f32-input pipeline: it is not
    given ``input_enc``, which the exported program then takes."""
    seen = {}

    def gate(dtype, state, overrides, **kw):
        seen.update(kw)
        return torch.float32

    monkeypatch.setattr(cli_export, "apply_dtype_gate", gate)
    path = cli_export.main([f"model_file=armadillo", f"ckpt_dir={ckpt}",
                            f"length={L}", "batch=b",
                            f"out={tmp_path / 'e.pt2'}", "device=cpu",
                            "max_echoes=8", "input_enc=s16"])
    assert seen and "input_enc" not in seen and seen["length"] == L
    served = load_pipeline(path)
    assert served.input_enc == "s16"
    assert served.raw_in_specs[0].dtype == torch.int16


@pytest.mark.parametrize("extra,match", [
    (["platforms=cpu,tpu"], "device="),
    (["model=edsr", "int8_calib=x.npy"], "model=stofnet only"),
    (["bogus=1"], "unknown argument"),
])
def test_cli_export_refusals(ckpt, extra, match):
    with pytest.raises(SystemExit, match=match):
        cli_export.main([f"model_file=armadillo", f"ckpt_dir={ckpt}",
                         "device=cpu", *extra])


def test_cli_export_needs_a_model_file():
    with pytest.raises(SystemExit, match="model_file="):
        cli_export.main(["device=cpu"])


def _serve(args, fn):
    hostd, server, port = build(args)
    try:
        return fn(hostd, port)
    finally:
        server.shutdown()
        server.server_close()
        hostd.close()


def test_daemon_from_one_artifact(weights, poly):
    """``artifact=`` serves the artifact's coords (the live pipeline's) to
    concurrent clients, every bucket warmed before the server binds."""
    _, state = weights
    _, _, path = poly
    x = _x(6, seed=60)

    def run(hostd, port):
        assert hostd.stats()["bucket_counts"] == {1: 0, 2: 0, 4: 0, 8: 0}
        got = [None] * 6

        def client(i):
            with ServingClient(("127.0.0.1", port)) as c:
                got[i] = c.infer(x[i, 0])

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        return np.stack(got)

    got = _serve({"artifact": str(path), "max_batch": 8, "port": 0}, run)
    np.testing.assert_array_equal(got, make_pipeline(state, OV, **KW)(x))


def test_daemon_routes_two_artifacts_by_length(weights, poly, tmp_path):
    """Two artifacts of two lengths behind one port: each request goes to
    its length's artifact; a fixed-batch artifact is its own bucket."""
    _, state = weights
    _, _, path = poly
    fixed = save_pipeline(tmp_path / "m4.pt2", export_pipeline(
        state, OV, 4, L_MODULE, **KW))
    a, b = _x(3, seed=70), _x(4, L_MODULE, seed=71)

    def run(hostd, port):
        assert hostd.lengths == (L, L_MODULE)
        with ServingClient(("127.0.0.1", port)) as c:
            return c.infer(a[:, 0]), c.infer(b[:, 0]), hostd.stats()

    got_a, got_b, stats = _serve({"artifact": f"{path},{fixed}",
                                  "max_batch": 4, "port": 0,
                                  "warmup": False}, run)
    live = make_pipeline(state, OV, **KW)
    np.testing.assert_array_equal(got_a, live(a))
    np.testing.assert_array_equal(got_b, live(b))
    assert stats["per_length"][L_MODULE]["bucket_counts"] == {4: 1}


def _dispatchers():
    return {t.name for t in threading.enumerate()
            if "serving-dispatch" in t.name}


def _no_leak(before):
    deadline = time.monotonic() + 10.0
    while _dispatchers() != before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert _dispatchers() == before, _dispatchers() - before


def test_daemon_refuses_two_artifacts_of_one_length(poly):
    _, _, path = poly
    before = _dispatchers()
    with pytest.raises(SystemExit, match="both serve length"):
        build({"artifact": f"{path},{path}", "max_batch": 8,
               "warmup": False})
    _no_leak(before)


def test_build_closes_hosts_on_failure(poly, tmp_path):
    """A failure after a host is built (the second artifact is missing)
    leaks no dispatcher thread."""
    _, _, path = poly
    before = _dispatchers()
    with pytest.raises(Exception):
        build({"artifact": f"{path},{tmp_path / 'missing.pt2'}",
               "max_batch": 8})
    _no_leak(before)


@pytest.mark.parametrize("args,match", [
    ({"max_batch": 8}, "max_batch=4"),
    ({"model_file": "armadillo"}, "not both"),
])
def test_daemon_artifact_refusals(weights, tmp_path, args, match):
    """A fixed-batch artifact serves only at its batch; ``artifact=`` and
    ``model_file=`` exclude each other."""
    _, state = weights
    path = save_pipeline(tmp_path / "b4.pt2", export_pipeline(
        state, OV, 4, L, **KW))
    before = _dispatchers()
    with pytest.raises(SystemExit, match=match):
        build({"artifact": str(path), "warmup": False, **args})
    _no_leak(before)
